"""``KGServer``: the live serving tier over ``KGQueryEngine`` (port of
``repro.serve.server``).

Individual link-prediction requests arrive asynchronously (single
``(h, r, ?)`` lookups, not pre-formed batches) and the server turns them
into the engine's batched calls without paying a cold shape, a cold
cache or a restart on the steady-state path:

  * **Continuous batching** — a batcher thread admits a *wave* of up to
    ``max_batch`` compatible requests (same tenant / query kind / k) or
    whatever arrived within ``max_wait_us`` of the oldest pending
    request, whichever fills first.  The wait bound caps the latency a
    lonely request pays for the batching.
  * **Padded-shape bucketing** — a wave of B requests is padded to the
    next power-of-two bucket and handed to the engine with
    ``chunk=bucket``, so every wave lands on one of ~log2(max_batch)
    shapes.  ``warmup()`` runs every bucket up front; after it, a
    mixed-size query stream runs with **zero steady-state recompiles**,
    counted against the engine's registry of the distinct computations it
    has run (``kg_engine.shapes_seen``; ``ServerStats.recompile_counter``
    reads ``"engine-shapes"``).  PyTorch compiles nothing, but the first
    call at a new shape pays allocator growth, sort workspaces and lazy
    module loads on the card; the registry is keyed on what the
    reference's jit cache keys on, so the gate counts the same events.
  * **LRU answer cache** — hot ``(h, r, k, exclusion)`` queries are
    answered from an LRU keyed by the owning artifact's
    ``KnowledgeBase.fingerprint()`` (model + tables + graph content), so
    a cached answer can never outlive the artifact that produced it.
    The cache keeps its own copy of each answer and hands out copies, so
    a caller who mutates an answer cannot corrupt it.
  * **Multi-KB tenancy + zero-downtime hot swap** — the server holds
    named tenants; ``swap(kb)`` builds and warms the new artifact's
    engine *while the old one keeps serving*, then flips the tenant
    pointer under the lock.  Waves bind their artifact at admission:
    in-flight waves drain against the old KB, every later admission sees
    the new one, and each response carries the fingerprint of the single
    artifact that answered it.  A swap that changes the fingerprint
    invalidates the answer cache.

Determinism: a served answer — batched into any wave size, padded into any
bucket slot, cached or freshly computed, before or after a hot swap — is
bit-identical to calling the bound artifact's ``KGQueryEngine`` directly
with the same query.  The engine scores each row on its own, in order,
and sorts each row stably, so a row's answer does not depend on the rows
around it; the pad rows the bucket adds (copies of row 0) are scored but
sliced off.

Threads share the device's default stream: every engine call, in a wave
or in a warm-up on the caller's thread, holds one lock, so a ``swap()``
warming a new engine never interleaves with a wave.  An exception in a
wave — a CUDA error included — is set on the wave's futures, and the
server keeps serving.  The server moves no table between devices: it
serves where the artifact's tables live.

**Over a mesh** (``backend="shard_map"``, ``mesh=``): every rank of the
mesh constructs the server with the same artifacts, and every engine call
is a collective all ranks must enter in the same order.  Wave boundaries
hang on timing, so ranks that batched on their own would deadlock: the
mesh's rank 0 alone owns the batcher, the answer cache, the counters and
the futures (``submit`` there only), and broadcasts each engine call it
makes — a wave that missed the cache as (tenant generation, kind, k, the
padded ids and exclusions, the bucket), a warm-up, a swap, a stop — over
a gloo command group of its own; every other rank runs a follower thread
that makes exactly those calls, in that order.  On a follower,
``warmup()`` does nothing (rank 0's warm-up runs there), ``swap(kb)``
hands the artifact to the follower, which binds it when rank 0's swap
arrives (and checks its fingerprint), and ``stop()`` waits, without a
cap, for rank 0's stop: call it when the follower's rank has nothing
else to do.

Every rank acknowledges each wave, warm-up and swap on the command group
twice — once it is ready for the call (it holds the tenant, or has bound
the swapped-in artifact), once the call has run — with a one-int
all-reduce.  If any rank failed, every rank learns each failure, the
followers stop following and the mesh server shuts down: rank 0 raises
the error from the wave's futures, ``warmup()`` or ``swap()``, refuses
later requests, and each follower's ``stop()`` raises it.  The command
group's collectives time out after ``CHANNEL_TIMEOUT_S`` (an idle rank 0
sends a heartbeat every ``HEARTBEAT_S``), so a lost rank 0 ends its
followers and a lost follower surfaces on rank 0 as an exception within
that bound.  A rank that fails inside an engine call before that call's
own collectives leaves the others waiting in them until the mesh's
process group times out: that bound is the mesh's.  While such a server
runs, its engine calls hold the mesh: run no other collective on it.
``stop()`` destroys the command group.  On a one-rank mesh there is
nothing to broadcast.

    kb = KnowledgeBase.load("my_kb")
    with KGServer(kb, max_batch=16, max_wait_us=2000, warm=True) as srv:
        ans = srv.query_tails(h, r, k=10)      # blocking convenience
        fut = srv.submit("tails", h, r)        # async, batched with peers
        srv.swap(KnowledgeBase.load("my_kb_v2"))   # zero downtime
        print(srv.stats())                     # p50/p99, QPS-side counters
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel import util as par
from repro_torch.serve import kg_engine

if TYPE_CHECKING:       # repro_torch.kb imports this package — keep it lazy
    from repro_torch.kb import KnowledgeBase

KINDS = ("tails", "heads", "relations")

#: over a mesh: the command group's collective timeout, and how long an
#: idle rank 0 waits before it sends its followers a heartbeat (both read
#: when a server is constructed)
CHANNEL_TIMEOUT_S = 120.0
HEARTBEAT_S = 2.0
#: the commands every rank acknowledges before it makes their calls
_ACKED = ("wave", "warm", "swap")


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _engine_cache_size() -> int:
    """How many distinct computations the engine has run in this process
    (``kg_engine.shapes_seen``): the ground truth behind
    ``steady_recompiles``."""
    return kg_engine.shapes_seen()


@dataclasses.dataclass(frozen=True)
class ServedAnswer:
    """One served query's answer: top-k ``ids``/``energies`` rows
    (best-first, +inf energies on exhausted/excluded slots — the engine's
    convention), stamped with the ``fingerprint`` of the exactly-one
    artifact that produced it, whether it was a ``cached`` hit, and the
    request's queue-to-answer ``latency_s``."""

    ids: np.ndarray
    energies: np.ndarray
    fingerprint: str
    kind: str
    cached: bool
    latency_s: float


@dataclasses.dataclass(frozen=True)
class ServerStats:
    """A consistent snapshot of the server's counters (see ``stats()``)."""

    requests: int
    completed: int
    cache_hits: int
    cache_misses: int
    waves: int
    mean_wave: float
    bucket_waves: Dict[int, int]
    warm_compiles: int
    steady_recompiles: int
    recompile_counter: str      # "engine-shapes"
    swaps: int
    cache_invalidations: int
    p50_ms: float
    p99_ms: float
    slo_p99_ms: Optional[float]
    slo_met: Optional[bool]


class _LRU:
    """Answer cache: OrderedDict LRU, capacity-bounded, caller locks."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)


@dataclasses.dataclass
class _Tenant:
    """One served artifact: the KB, its engine, its content fingerprint,
    and the fixed exclusion-mask width filtered waves pad to (lazy —
    computed from the graph's max known fanout so every filtered wave of
    a bucket has one shape)."""

    kb: KnowledgeBase
    engine: kg_engine.KGQueryEngine
    fp: str
    gen: int = 0                    # its number on every rank of a mesh
    ex_width: Optional[int] = None


class _Request:
    __slots__ = ("kind", "a", "b", "k", "filtered", "exclude", "tenant",
                 "future", "t_submit")

    def __init__(self, kind, a, b, k, filtered, exclude, tenant):
        self.kind = kind
        self.a = int(a)
        self.b = int(b)
        self.k = int(k)
        self.filtered = bool(filtered)
        self.exclude = exclude          # normalized sorted tuple or None
        self.tenant = tenant
        self.future: Future = Future()
        self.t_submit = time.monotonic()

    @property
    def group(self) -> Tuple:
        """Wave compatibility: one admitted wave = one engine call."""
        return (self.tenant, self.kind, self.k)


class KGServer:
    """Continuous-batching KG link-prediction server (module docstring).

    ``max_batch`` caps a wave; ``max_wait_us`` bounds how long the oldest
    pending request waits for peers.  ``n_workers``/``backend``/``mesh``/
    ``table_sharding`` pick the engine every tenant uses
    (``KnowledgeBase.engine``; ``backend="shard_map"`` over ``mesh``:
    every rank constructs the server, rank 0 serves, module docstring).
    ``default_k``
    is the k ``submit`` uses when none is given *and* the k ``warmup``
    runs — traffic at other k values meets its own bucket shapes cold on
    first use.  ``warm=True`` warms every bucket at construction.

    ``on_wave_start`` is a test hook called right after a wave binds its
    artifact, before the engine call: ``f(kind, size, bucket, tenant,
    fingerprint)``.
    """

    def __init__(
        self,
        kb: Optional[KnowledgeBase] = None,
        *,
        tenants: Optional[Dict[str, KnowledgeBase]] = None,
        max_batch: int = 16,
        max_wait_us: int = 2000,
        cache_size: int = 4096,
        default_k: int = 10,
        n_workers: int = 1,
        backend: str = "vmap",
        mesh=None,
        table_sharding: str = "replicated",
        slo_p99_ms: Optional[float] = None,
        warm: bool = False,
        on_wave_start: Optional[Callable] = None,
    ):
        if kb is None and not tenants:
            raise ValueError("pass a KnowledgeBase (or tenants={name: kb})")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_us / 1e6
        self.default_k = int(default_k)
        self.n_workers = n_workers
        self.backend = backend
        self.mesh = mesh
        self.table_sharding = table_sharding
        self.slo_p99_ms = slo_p99_ms
        self.on_wave_start = on_wave_start
        self.buckets = tuple(
            1 << i for i in range(_pow2ceil(self.max_batch).bit_length()))

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._compile_lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._cache = _LRU(cache_size)
        self._tenants: Dict[str, _Tenant] = {}
        self._warmed = False
        self._accepting = True
        self._paused = False
        self._inflight = 0          # waves taken but not yet answered

        # counters (under self._lock)
        self._requests = 0
        self._completed = 0
        self._hits = 0
        self._misses = 0
        self._waves = 0
        self._wave_rows = 0
        self._bucket_waves: Dict[int, int] = {}
        self._warm_compiles = 0
        self._steady_recompiles = 0
        self._swaps = 0
        self._invalidations = 0
        self._latencies: collections.deque = collections.deque(maxlen=100_000)

        # over a mesh of M > 1 ranks: the command channel (module docstring)
        self._meshed = False
        self._channel = None
        self._leader = True
        self._gens = 0
        self._by_gen: Dict[int, _Tenant] = {}   # a follower's tenants
        self._bound: Dict[int, int] = {}        # rank 0: waves per gen
        self._retired: set = set()              # rank 0: swapped-out gens
        self._to_drop: set = set()              # ... followers may free
        self._closed = False
        self._handoff: queue.Queue = queue.Queue()
        #: a follower's error; on rank 0, the failure its followers reported
        self.follower_error: Optional[BaseException] = None
        if backend == "shard_map" and mesh is not None:
            self._open_channel(mesh)

        named = dict(tenants or {})
        if kb is not None:
            named.setdefault("default", kb)
        for name, each in named.items():
            self._tenants[name] = self._make_tenant(each)
            self._by_gen[self._tenants[name].gen] = self._tenants[name]

        self._thread = threading.Thread(
            target=self._run if self._leader else self._follow,
            name="kg-server-batcher" if self._leader
            else "kg-server-follower", daemon=True)
        self._thread.start()
        if warm:
            self.warmup()

    # -- the command channel over a mesh -----------------------------------

    def _open_channel(self, mesh) -> None:
        """A gloo group over the mesh's ranks for rank 0's commands (every
        rank of the default group calls ``new_group``); none on one rank."""
        import torch.distributed as dist

        par.check_mesh(mesh)
        if par.mesh_size(mesh) == 1:
            return
        ranks = dist.get_process_group_ranks(mesh.get_group(par.AXIS))
        self._src = ranks[0]
        self._leader = par.mesh_rank(mesh) == 0
        self._meshed = True
        self._timeout_s = CHANNEL_TIMEOUT_S
        self._heartbeat_s = HEARTBEAT_S
        self._channel = dist.new_group(
            ranks, timeout=timedelta(seconds=CHANNEL_TIMEOUT_S),
            backend="gloo")

    def _send(self, *cmd) -> None:
        """Rank 0: broadcast one command (with the generations the
        followers may free) to the followers, and for a wave, warm-up or
        swap take every rank's word that it is ready for it
        (:meth:`_agree`); the caller holds ``_compile_lock``, so commands
        go out in the order the engine calls run."""
        if not self._meshed:
            return
        import torch.distributed as dist

        if self._closed:
            raise RuntimeError(
                "KGServer's followers have stopped") from self.follower_error
        with self._lock:
            drop, self._to_drop = sorted(self._to_drop), set()
        try:
            dist.broadcast_object_list([(cmd, drop)], src=self._src,
                                       group=self._channel)
        except Exception as exc:
            self._break(exc)
            raise
        if cmd[0] in _ACKED:
            self._agree(None)

    def _agree(self, exc: Optional[BaseException]) -> None:
        """Every rank's word on the step of a command it has just taken
        (``exc`` is None when it went well): a one-int all-reduce of the
        failures over the command group.  If any rank failed, the ranks
        all-gather the failures' text, the mesh server breaks
        (:meth:`_break`) and this raises the failure on every rank."""
        import torch.distributed as dist

        try:
            failed = torch.tensor([int(exc is not None)], dtype=torch.int32)
            dist.all_reduce(failed, group=self._channel)
            if not int(failed):
                return
            notes = [None] * par.mesh_size(self.mesh)
            dist.all_gather_object(
                notes, None if exc is None else
                f"rank {par.mesh_rank(self.mesh)}: {exc!r}",
                group=self._channel)
            err = RuntimeError("KGServer over the mesh failed: "
                               + "; ".join(n for n in notes if n))
        except Exception as channel_exc:
            self._break(channel_exc)
            raise
        self._break(err)
        raise err from exc

    def _agreed(self, fn, *args):
        """``fn(*args)`` on this rank; over a mesh, followed by every
        rank's word that its call went well (:meth:`_agree`)."""
        if not self._meshed:
            return fn(*args)
        try:
            out = fn(*args)
        except Exception as exc:
            self._agree(exc)
            raise                           # not reached: _agree raises
        self._agree(None)
        return out

    def _break(self, exc: BaseException) -> None:
        """The mesh server is done after ``exc``: no command goes out or
        is followed any more; rank 0 refuses new requests and fails the
        queued ones."""
        with self._cond:
            self._closed = True
            if self.follower_error is None:
                self.follower_error = exc
            if self._leader:
                self._accepting = False
                while self._pending:
                    self._pending.popleft().future.set_exception(exc)
                self._cond.notify_all()

    def _close_channel(self) -> None:
        """Destroy the command group (this rank's handle of it)."""
        if self._channel is not None:
            import torch.distributed as dist

            dist.destroy_process_group(self._channel)
            self._channel = None

    def _follow(self) -> None:
        """A follower rank's loop: receive rank 0's commands and make
        exactly its engine calls, acknowledging each (:meth:`_agree`),
        until its stop, a failure on any rank, or a channel error (rank
        0 lost, the timeout passed)."""
        import torch.distributed as dist

        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=self._src,
                                           group=self._channel)
            except Exception as exc:            # noqa: BLE001 — kept
                self._break(exc)
                return
            cmd, drop = box[0]
            for gen in drop:
                self._by_gen.pop(gen, None)
            op, args = cmd[0], cmd[1:]
            if op == "stop":
                return
            try:
                if op == "swap":
                    self._agreed(self._bind_handoff, *args)
                elif op in ("wave", "warm"):
                    tenant = self._agreed(self._by_gen.__getitem__, args[0])
                    call = self._engine_call if op == "wave" else (
                        self._warm_calls)
                    self._agreed(call, tenant, *args[1:])
            except Exception:                   # noqa: BLE001 — kept by
                return                          # _break, raised by stop()

    def _bind_handoff(self, name: str, gen: int, fp: str) -> None:
        """A follower's side of rank 0's swap: the artifact this rank's
        ``swap()`` handed in, checked against rank 0's fingerprint."""
        try:
            got, kb = self._handoff.get(timeout=self._timeout_s / 2)
        except queue.Empty:
            raise RuntimeError(
                f"rank 0 swapped tenant {name!r} but this rank's swap() "
                f"handed in no artifact within {self._timeout_s / 2} s"
            ) from None
        if got != name or kb.fingerprint() != fp:
            raise RuntimeError(
                f"swap of tenant {name!r} on rank 0 to fingerprint {fp} but "
                f"this rank was handed {got!r} at {kb.fingerprint()}")
        self._tenants[name] = self._by_gen[gen] = self._make_tenant(kb, gen)

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "KGServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop accepting requests; by default drain what's queued first.
        Over a mesh rank 0 then stops its followers; on a follower this
        waits for that stop (up to ``timeout`` seconds, by default without
        a cap: a lost rank 0 ends the follower within the command group's
        timeout) and raises the error the mesh server failed with, if it
        failed.  Either way the command group is destroyed."""
        if not self._leader:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"no stop from the mesh's rank 0 within {timeout} s")
            self._close_channel()
            if self.follower_error is not None:
                raise RuntimeError("KGServer follower failed") from (
                    self.follower_error)
            return
        with self._cond:
            self._accepting = False
            self._paused = False
            if not drain:
                while self._pending:
                    self._pending.popleft().future.set_exception(
                        RuntimeError("KGServer stopped"))
            self._cond.notify_all()
        self._thread.join(timeout=30)
        if self._meshed:
            with self._compile_lock:
                try:
                    if not self._closed:
                        self._send("stop")
                        self._closed = True
                finally:
                    self._close_channel()

    def pause(self) -> None:
        """Hold admission (requests queue up) — lets tests compose exact
        waves; also the knob a drain-before-maintenance script would use."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every pending request has been answered: the queue
        is empty and no admitted wave is still executing.  Returns True
        when drained, False on timeout.  Fences "answers admitted under
        artifact N" from "swap to artifact N+1"; ordinary swaps don't need
        it — waves bind their artifact at admission regardless."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending or self._inflight:
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cond.wait(timeout=remaining)
        return True

    # -- tenancy -----------------------------------------------------------

    def _make_tenant(self, kb: KnowledgeBase,
                     gen: Optional[int] = None) -> _Tenant:
        engine = kb.engine(n_workers=self.n_workers, backend=self.backend,
                           mesh=self.mesh,
                           table_sharding=self.table_sharding)
        with self._lock:
            if gen is None:
                gen = self._gens
            self._gens = max(self._gens, gen + 1)
        return _Tenant(kb=kb, engine=engine, fp=kb.fingerprint(), gen=gen)

    def tenant_fingerprint(self, tenant: str = "default") -> str:
        with self._lock:
            return self._tenants[tenant].fp

    def tenant_kb(self, tenant: str = "default") -> KnowledgeBase:
        """The artifact currently bound to ``tenant`` (what the next
        admitted wave will answer from)."""
        with self._lock:
            return self._tenants[tenant].kb

    def clear_cache(self) -> None:
        """Drop every cached answer (an ops knob — e.g. isolating
        measurement cells in benchmarks; correctness never needs it, keys
        are fingerprint-scoped)."""
        with self._lock:
            self._cache.clear()

    def swap(self, kb: KnowledgeBase, tenant: str = "default",
             warm: Optional[bool] = None) -> Optional[KnowledgeBase]:
        """Hot-swap ``tenant`` to a new artifact with zero downtime: the
        replacement engine is built — and warmed, when the server is warm
        (override with ``warm=``) — while the old artifact keeps
        answering, then the pointer flips.  Waves admitted before the
        flip drain against the old KB; everything admitted after sees the
        new one.  If the new fingerprint differs, the answer cache is
        invalidated (a cached answer must never outlive its artifact).
        Returns the replaced KnowledgeBase (None for a fresh tenant).

        On a follower rank of a mesh: hands ``kb`` to the follower thread,
        which binds it when rank 0's swap of ``tenant`` arrives, and
        returns None."""
        if not self._leader:
            self._handoff.put((tenant, kb))
            return None
        new = self._make_tenant(kb)
        with self._compile_lock:
            self._send("swap", tenant, new.gen, new.fp)
        if warm if warm is not None else self._warmed:
            self._warm_tenant(new)
        with self._cond:
            old = self._tenants.get(tenant)
            self._tenants[tenant] = new
            self._swaps += 1
            if old is not None and old.fp != new.fp:
                self._cache.clear()
                self._invalidations += 1
            if old is not None:
                self._retired.add(old.gen)
                self._free_retired_locked()
        return old.kb if old is not None else None

    def _free_retired_locked(self) -> None:
        """Rank 0, under ``_lock``: swapped-out generations no admitted
        wave still holds go on the list the followers may free."""
        if not self._meshed:
            self._retired.clear()
            return
        for gen in [g for g in self._retired if not self._bound.get(g)]:
            self._retired.discard(gen)
            self._to_drop.add(gen)

    def add_tenant(self, name: str, kb: KnowledgeBase,
                   warm: Optional[bool] = None) -> None:
        """Serve an additional artifact under ``name`` (see ``swap``)."""
        self.swap(kb, tenant=name, warm=warm)

    # -- warmup / shape accounting -----------------------------------------

    def warmup(self, ks: Optional[Tuple[int, ...]] = None,
               kinds: Tuple[str, ...] = KINDS,
               filtered: Optional[bool] = None) -> int:
        """Run every (kind, k, bucket) shape traffic will hit so the steady
        state never meets a cold one: for each tenant, each bucket gets
        the unfiltered exclusion shape and — when the tenant ships a
        graph (``filtered`` overrides) — the fixed full-width filtered
        shape, whose width needs the graph's known-triplet index (built
        here, not at the first live query).  Returns the number of shapes
        new to the engine (also recorded as
        ``ServerStats.warm_compiles``); after warmup, any further new
        shape observed around a wave counts as a steady-state
        recompile.  On a follower rank of a mesh: returns 0 at once (rank
        0's warm-up makes the calls there)."""
        if not self._leader:
            return 0
        total = 0
        with self._lock:
            tenants = list(self._tenants.values())
        for tenant in tenants:
            total += self._warm_tenant(tenant, ks=ks, kinds=kinds,
                                       filtered=filtered)
        with self._lock:
            self._warmed = True
        return total

    def _warm_tenant(self, tenant: _Tenant, ks=None, kinds=KINDS,
                     filtered=None) -> int:
        ks = tuple(ks) if ks else (self.default_k,)
        if filtered is None:
            filtered = tenant.kb.graph is not None
        # host work (the known index) stays outside the engine lock
        widths = [None, self._ex_width(tenant)] if filtered else [None]
        with self._compile_lock:
            self._send("warm", tenant.gen, ks, tuple(kinds), widths)
            before = _engine_cache_size()
            self._agreed(self._warm_calls, tenant, ks, kinds, widths)
            fresh = _engine_cache_size() - before
        with self._lock:
            self._warm_compiles += fresh
        return fresh

    def _warm_calls(self, tenant: _Tenant, ks, kinds, widths) -> None:
        """The engine calls of a warm-up, one per (k, bucket, width, kind),
        in one order on every rank."""
        E = tenant.engine.n_entities
        for k in ks:
            for bucket in self.buckets:
                ids = np.zeros(bucket, np.int32)
                for width in widths:
                    ex = (None if width is None else
                          np.full((bucket, width), E, np.int32))
                    if "tails" in kinds:
                        tenant.engine.query_tails(
                            ids, ids, k=k, exclude=ex, chunk=bucket)
                    if "heads" in kinds:
                        tenant.engine.query_heads(
                            ids, ids, k=k, exclude=ex, chunk=bucket)
                if "relations" in kinds:
                    tenant.engine.query_relations(
                        ids, ids, k=k, chunk=bucket)

    def _ex_width(self, tenant: _Tenant) -> int:
        """Fixed filtered-exclusion width: pow2 of the graph's max known
        fanout, so filtered waves of a bucket share one shape."""
        if tenant.ex_width is None:
            by_hr, by_rt = tenant.kb.graph.known_index()
            widest = max(
                max((len(v) for v in by_hr.values()), default=1),
                max((len(v) for v in by_rt.values()), default=1))
            tenant.ex_width = _pow2ceil(widest)
        return tenant.ex_width

    # -- submission --------------------------------------------------------

    def submit(self, kind: str, a, b, k: Optional[int] = None,
               tenant: str = "default", filtered: bool = False,
               exclude=None) -> Future:
        """Enqueue one query; returns a Future resolving to a
        ``ServedAnswer``.  ``kind``: 'tails' answers (a=h, b=r, ?),
        'heads' answers (?, b=r, a=t), 'relations' answers (a=h, ?, b=t).
        ``filtered`` excludes the tenant graph's known neighbors;
        ``exclude`` is an explicit candidate-id blacklist (entity kinds
        only — note off-bucket exclusion widths meet a fresh shape).  Over
        a mesh only rank 0 admits requests."""
        if not self._leader:
            raise RuntimeError(
                "submit on the mesh's rank 0: the other ranks follow its "
                "engine calls")
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if kind == "relations" and (filtered or exclude is not None):
            raise ValueError(
                "relation queries take no exclusion (filtered/exclude are "
                "entity-query options)")
        if exclude is not None:
            exclude = tuple(sorted({int(x) for x in np.atleast_1d(exclude)}))
        k = self.default_k if k is None else int(k)
        req = _Request(kind, a, b, k, filtered, exclude, tenant)
        with self._cond:
            if not self._accepting:
                raise RuntimeError("KGServer is stopped")
            ten = self._tenants.get(tenant)
            if ten is None:
                raise KeyError(f"unknown tenant {tenant!r} "
                               f"(have {sorted(self._tenants)})")
            if filtered and ten.kb.graph is None:
                raise ValueError(
                    f"filtered=True needs tenant {tenant!r}'s graph; its "
                    "KnowledgeBase was loaded without one")
            self._requests += 1
            hit = self._cache.get(self._cache_key(req, ten.fp))
            if hit is not None:
                self._hits += 1
                self._completed += 1
                lat = time.monotonic() - req.t_submit
                self._latencies.append(lat)
                ids, energies = hit
                req.future.set_result(ServedAnswer(
                    ids=ids.copy(), energies=energies.copy(),
                    fingerprint=ten.fp, kind=kind, cached=True,
                    latency_s=lat))
                return req.future
            self._misses += 1
            self._pending.append(req)
            self._cond.notify_all()
        return req.future

    # blocking conveniences (submit + wait) --------------------------------

    def query_tails(self, h, r, k: Optional[int] = None,
                    **kw) -> ServedAnswer:
        return self.submit("tails", h, r, k, **kw).result()

    def query_heads(self, t, r, k: Optional[int] = None,
                    **kw) -> ServedAnswer:
        return self.submit("heads", t, r, k, **kw).result()

    def query_relations(self, h, t, k: Optional[int] = None,
                        **kw) -> ServedAnswer:
        return self.submit("relations", h, t, k, **kw).result()

    @staticmethod
    def _cache_key(req: _Request, fp: str) -> Tuple:
        return (fp, req.kind, req.a, req.b, req.k, req.filtered,
                req.exclude)

    # -- the batcher -------------------------------------------------------

    def _take_locked(self, gkey: Tuple, limit: int) -> list:
        """Pop up to ``limit`` pending requests compatible with ``gkey``,
        preserving FIFO order of everything left behind."""
        taken, keep = [], collections.deque()
        while self._pending:
            req = self._pending.popleft()
            if len(taken) < limit and req.group == gkey:
                taken.append(req)
            else:
                keep.append(req)
        self._pending = keep
        return taken

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._idle_locked():
                    wave = None
                elif not self._pending:
                    return          # stopped and drained
                else:
                    head = self._pending[0]
                    gkey = head.group
                    deadline = head.t_submit + self.max_wait_s
                    wave = self._take_locked(gkey, self.max_batch)
                    while len(wave) < self.max_batch and self._accepting:
                        now = time.monotonic()
                        if now >= deadline:
                            break
                        self._cond.wait(timeout=deadline - now)
                        wave.extend(self._take_locked(
                            gkey, self.max_batch - len(wave)))
                    # bind the artifact: this wave is consistent with
                    # exactly this tenant object, whatever swap() does
                    # afterwards
                    tenant = self._tenants[gkey[0]]
                    self._inflight += 1
                    self._bound[tenant.gen] = self._bound.get(
                        tenant.gen, 0) + 1
            if wave is None:        # idle over a mesh: a heartbeat
                with self._compile_lock:
                    if not self._closed:
                        try:
                            self._send("tick")
                        except Exception:   # noqa: BLE001 — _break kept
                            pass            # it; the loop then ends
                continue
            try:
                self._execute(wave, tenant)
            except Exception as exc:          # noqa: BLE001 — surface to
                for req in wave:              # callers, keep serving
                    if not req.future.done():
                        req.future.set_exception(exc)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._bound[tenant.gen] -= 1
                    self._free_retired_locked()
                    self._cond.notify_all()

    def _idle_locked(self) -> bool:
        """Under ``_cond``: wait until a wave can be admitted or the
        server stops (False); over a mesh, an idle wait of ``HEARTBEAT_S``
        returns True instead, for a heartbeat to the followers."""
        while self._accepting and (self._paused or not self._pending):
            if not self._meshed:
                self._cond.wait()
            elif not self._cond.wait(timeout=self._heartbeat_s):
                return True
        return False

    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _wave_exclusion(self, wave: list, tenant: _Tenant,
                        bucket: int) -> Optional[np.ndarray]:
        """(bucket, width) padded exclusion rows for an entity-query wave;
        None when nothing in the wave excludes anything (width-1 default
        shape inside the engine)."""
        if not any(req.filtered or req.exclude for req in wave):
            return None
        E = tenant.engine.n_entities
        width = self._ex_width(tenant) if any(
            req.filtered for req in wave) else 1
        for req in wave:
            if req.exclude:
                width = max(width, _pow2ceil(len(req.exclude)))
        ex = np.full((bucket, width), E, np.int32)
        side = "tail" if wave[0].kind == "tails" else "head"
        filt = [i for i, req in enumerate(wave) if req.filtered]
        if filt:
            pairs = np.array([[wave[i].a, wave[i].b] for i in filt],
                             np.int64)
            if side == "head":
                # known_candidate_masks wants (r, t) rows for heads
                pairs = pairs[:, ::-1]
            masks = tenant.kb.graph.known_candidate_masks(pairs, side)
            ex[filt, :masks.shape[1]] = masks
        for i, req in enumerate(wave):
            if req.exclude:
                ex[i, :len(req.exclude)] = np.asarray(req.exclude, np.int32)
        return ex

    def _execute(self, wave: list, tenant: _Tenant) -> None:
        kind, k = wave[0].kind, wave[0].k
        B = len(wave)
        bucket = self._bucket_of(B)
        # pad by repeating row 0 — scored harmlessly, sliced off (the
        # eval engine's padding trick); never aliases a live row's answer
        a = np.full(bucket, wave[0].a, np.int32)
        b = np.full(bucket, wave[0].b, np.int32)
        for i, req in enumerate(wave):
            a[i], b[i] = req.a, req.b
        ex = (None if kind == "relations"
              else self._wave_exclusion(wave, tenant, bucket))
        if self.on_wave_start is not None:
            self.on_wave_start(kind, B, bucket, wave[0].tenant, tenant.fp)
        with self._compile_lock:
            self._send("wave", tenant.gen, kind, a, b, k, ex, bucket)
            before = _engine_cache_size()
            res = self._agreed(self._engine_call, tenant, kind, a, b, k, ex,
                               bucket)
            fresh = _engine_cache_size() - before
        t_done = time.monotonic()
        answers = []
        for i, req in enumerate(wave):
            lat = t_done - req.t_submit
            answers.append((req, ServedAnswer(
                ids=np.array(res.ids[i]),
                energies=np.array(res.energies[i]),
                fingerprint=tenant.fp, kind=kind, cached=False,
                latency_s=lat)))
        with self._lock:
            self._waves += 1
            self._wave_rows += B
            self._bucket_waves[bucket] = self._bucket_waves.get(
                bucket, 0) + 1
            if self._warmed and fresh > 0:
                self._steady_recompiles += fresh
            for req, ans in answers:
                self._completed += 1
                self._latencies.append(ans.latency_s)
                self._cache.put(self._cache_key(req, tenant.fp),
                                (ans.ids.copy(), ans.energies.copy()))
        for req, ans in answers:
            req.future.set_result(ans)

    @staticmethod
    def _engine_call(tenant: _Tenant, kind: str, a, b, k: int, ex,
                     bucket: int) -> kg_engine.QueryResult:
        """A wave's one engine call (on every rank of a mesh)."""
        if kind == "relations":
            return tenant.engine.query_relations(a, b, k=k, chunk=bucket)
        if kind == "tails":
            return tenant.engine.query_tails(a, b, k=k, exclude=ex,
                                             chunk=bucket)
        return tenant.engine.query_heads(a, b, k=k, exclude=ex, chunk=bucket)

    # -- observability -----------------------------------------------------

    def stats(self) -> ServerStats:
        with self._lock:
            lats = np.asarray(self._latencies, np.float64)
            p50 = float(np.percentile(lats, 50) * 1e3) if lats.size else 0.0
            p99 = float(np.percentile(lats, 99) * 1e3) if lats.size else 0.0
            return ServerStats(
                requests=self._requests,
                completed=self._completed,
                cache_hits=self._hits,
                cache_misses=self._misses,
                waves=self._waves,
                mean_wave=(self._wave_rows / self._waves
                           if self._waves else 0.0),
                bucket_waves=dict(sorted(self._bucket_waves.items())),
                warm_compiles=self._warm_compiles,
                steady_recompiles=self._steady_recompiles,
                recompile_counter="engine-shapes",
                swaps=self._swaps,
                cache_invalidations=self._invalidations,
                p50_ms=p50,
                p99_ms=p99,
                slo_p99_ms=self.slo_p99_ms,
                slo_met=(None if self.slo_p99_ms is None or not lats.size
                         else bool(p99 <= self.slo_p99_ms)),
            )
