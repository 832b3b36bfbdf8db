"""The MapReduce KG-embedding engine (paper §3), port of
``repro.core.mapreduce``: the ``host`` and ``device`` pipelines on the
``vmap`` and ``shard_map`` backends.  Most callers use
``repro_torch.kg.fit``.

Two paradigms, as the paper structures them:

  * **SGD-based** (§3.1): Map = each worker runs a full local-SGD epoch on
    its balanced subset with a private copy of the embeddings; Reduce =
    merge the W inconsistent copies per key (``core/merge.py``), table by
    table, routed by the model's ``param_roles()``.
  * **BGD-based** (§3.2): Map = each worker computes the *gradient* of its
    batch; Reduce = mean of the gradients; one global update.

The W workers are simulated on one device, as the reference's ``vmap``
backend does: the SGD workers' tables are one stacked ``(W, N, k)`` tensor
on the card, and each step of all W workers is one launch of each
``transe_score`` kernel (BGD's shared tables enter the kernels as a
worker-stride-0 view, so each worker's gradient comes back separately).
Every registered model trains here (TransE, TransH, DistMult; the Reduce
routes each table by ``param_roles()``), with either objective
(``KGConfig.negatives``): the per-triplet margin loss, or the joint one
that scores each worker's batch against its own shared candidate pool.

The training step makes no host sync.  ``train()`` proves every id in
range once — the partition on the host at start, injected draws when they
are handed in; the port's own negatives, ``(id + offset) % E`` with
``offset`` in ``[1, E)``, are in range by construction — and the step
calls the kernels with ``check_ids=False``.

Two **data pipelines**, selected by ``MapReduceConfig.pipeline``:

  * ``host``   — one epoch at a time: the epoch's batches built on the host
                 (``data/kg.epoch_batches``, a pure function of (seed,
                 epoch)), negatives and the ``random`` strategy's
                 priorities drawn from CPU ``torch.Generator``s seeded by
                 (seed, epoch, stream), one Reduce and one loss read per
                 epoch.
  * ``device`` — blocks of epochs (``make_block_fn``): the partition is put
                 on the device once, and each epoch's batches, negatives,
                 merge priorities and re-partition permutations are drawn
                 on the device from counter-based keys (``core/keys.py``),
                 a pure function of (seed, stream, epoch, worker) with the
                 same bits on every device.  Nothing inside a block syncs
                 with the host; its losses come back as one device tensor
                 and callbacks fire at block boundaries.

Epoch scheduling (``EpochSchedule``, device pipeline only):

  * ``block_epochs``  — epochs per block (one block function call; any
                        block size gives the same bits).
  * ``merge_every=K`` — SGD workers run K local epochs between Reduces
                        (touch stats accumulate across the K epochs).
  * ``repartition_every=M`` — re-split the triplets across workers on the
                        device every M epochs (round ``e // M`` indexes a
                        fresh global permutation; round 0 is the original
                        partition).
  * ``donate_params`` — (``MapReduceConfig``) the block takes the params
                        dict it is given and drops its references early.

Either pipeline's draws are a pure function of (seed, absolute epoch), so
one seed gives the same run twice, on any block split.  The reference
draws from a ``jax.random`` key chain instead; ``train(draws=...)`` takes
an epoch's draws from the caller, which is how the parity tests replay the
reference's.

In-training evaluation and checkpoint/resume ride the Reduce boundaries
(every epoch on the host pipeline; every ``merge_every`` epochs on the
device pipeline, whose driver slices its blocks there):
``train(eval_loop=...)`` evaluates every ``eval_every`` epochs and at the
last one (``core/trace.py``: a ``TrainingTrace``, early stopping on
``patience``, the best params kept), and ``train(checkpoint=...)`` saves
params and a manifest (:class:`CheckpointConfig`, through
``train/checkpoint.py``'s ``AsyncSaver`` by default).  A resume
(``start_epoch`` with the saved params and loss history) continues
bit-identically, since every epoch's draws are a pure function of (seed,
absolute epoch).  The manifest holds the reference's fields
(:func:`resume_config` among them), so a checkpoint resumes in either
package.

Two **Reduce transports**, selected by ``MapReduceConfig.merge_transport``
(``core/merge.py``'s transport section):

  * ``dense``  — the Map steps update whole stacked tables and the Reduce
                 merges them whole.
  * ``sparse`` — the SGD step works on compact tables of the rows its
                 batch references (``KGModel.sgd_step_sparse``), and the
                 Reduce merges each worker's packed delta buffer of the
                 rows it touched (:func:`_merge_tables_sparse_stacked`);
                 BGD restricts its gradient mean and update to the rows
                 the step's batches reference.  The same bits as
                 ``dense``, on either pipeline.  Buffers have a static
                 capacity; a round touching more rows raises
                 ``RuntimeError`` at its Reduce boundary
                 (:func:`_raise_on_overflow`), read once an epoch on the
                 host pipeline and once a block on the device pipeline.

Two **table layouts**, selected by ``MapReduceConfig.table_sharding``
(sparse transport only): ``replicated`` merges whole tables, ``sharded``
routes each merged row to the shard that owns it (shard ``s`` owns rows
``[s·R, (s+1)·R)``, ``R = ceil(N / W)``; ``core/merge.py``'s sharded
section) and, under BGD, updates each shard's candidate rows apart.  On
the ``vmap`` backend the W shards run one after another on one device;
the result is the replicated layout's, bitwise.

**Bounded staleness** (``MapReduceConfig.staleness=S > 0``, SGD on the
device pipeline): each worker keeps its own local copy across rounds and
adopts the global view only every ``S + 1`` rounds, at a phase ``o_w`` in
``[0, S]`` drawn from (seed, w) (``core/keys.stale_offsets``), and always
at round 0.  Its Reduce is participation-masked (``core/merge.py``'s
stale section).  The block state is then ``(global_view,
worker_locals)``; evaluation, callbacks and the result read the global
view.  A stale run cannot checkpoint or resume (its state holds every
worker's local tables); it reproduces by rerunning.

**The masked fine-tune** (``train(update_mask=...)``, SGD on the device
pipeline and the sparse transport): one bool row mask per table freezes
every row whose bit is False bitwise — in the compact step, the
projections and after each Reduce — while the free rows train; the
online tier's ``update()`` (``repro_torch.online``) is this call.

Two **backends**, selected by ``MapReduceConfig.backend``:

  * ``vmap``      — the W workers simulated on one device (above).
  * ``shard_map`` — SPMD over the ranks of a ``DeviceMesh`` (``train(mesh=
                    ...)``, ``parallel/util.py``): every rank calls the
                    same function and runs its block of ``W/M`` workers
                    stacked; the Reduce is a collective.  Under
                    ``reduce_impl="allgather"`` and on the sparse
                    transport the result is the vmap backend's bits; the
                    ``psum`` Reduce and dense BGD (the reference's
                    ``pmean`` of the gradients every step) add across
                    ranks in the backend's order, the vmap bits at M = 1
                    and within rtol 1e-4 / atol 1e-5 at M > 1.  Losses are
                    all-gathered and summed in worker order, the vmap
                    bits under every Reduce.  Sharded tables there route
                    each merged row block to the rank whose worker owns it
                    (``merge_lib.merge_sparse_sharded_collective``), and
                    on the device pipeline a dividing entity-role table
                    rests between blocks as the row blocks of the rank's
                    workers (``parallel/sharding.py``), all-gathered
                    whole at each block's start.  Bounded staleness there
                    keeps each rank's workers' locals on the rank and
                    Reduces by all-gathers (:func:`_merge_tables_stale_
                    collective`).  Both give the vmap backend's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import keys as keys_lib
from repro_torch.core import merge as merge_lib
from repro_torch.core import models as kg_models
from repro_torch.core import negative
from repro_torch.core import trace as trace_lib
from repro_torch.core.models.base import (
    EpochStats, KGConfig, KGModel, Params, apply_gradients)
from repro_torch.data import kg as kg_lib
from repro_torch.parallel import sharding as sharding_lib
from repro_torch.parallel import util as par
from repro_torch.train import checkpoint as checkpoint_lib
from repro_torch.util import exact_div, pairwise_mean, warn_fresh

#: an epoch's draws on the host pipeline: its negatives (W, S, B, 3) and,
#: for the ``random`` strategy, each table's merge priorities (W, N); on
#: the device pipeline its batches (W, S, B, 3) come first
Draws = Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]
DeviceDraws = Tuple[np.ndarray, np.ndarray,
                    Optional[Dict[str, np.ndarray]]]

_NEGATIVES, _PRIORITIES = 0, 1          # per-epoch random streams


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """How the device pipeline groups epochs (see the module docstring).

    ``block_epochs`` epochs run in one block function call (any block size
    gives the same bits); every ``merge_every`` epochs the SGD Reduce runs,
    so K > 1 lets each Map worker take K local epochs between merges.
    ``block_epochs`` must be a multiple of ``merge_every`` (blocks end on
    a merge boundary).

    ``repartition_every=M`` re-splits the triplets across workers on the
    device every M epochs (``data/kg.device_repartition``): the effective
    partition of epoch ``e`` is a pure function of (seed, ``e // M``) —
    round 0 is the original partition — so block invariance holds and
    ``M >= epochs`` is bit-identical to ``M=None`` (off).  M must be a
    multiple of ``merge_every``: workers hold their subset for whole
    Reduce rounds, and the driver slices blocks at re-partition boundaries
    so each round's permutation is drawn once."""

    block_epochs: int = 1
    merge_every: int = 1
    repartition_every: Optional[int] = None

    def __post_init__(self):
        if self.block_epochs < 1:
            raise ValueError(
                f"block_epochs must be >= 1, got {self.block_epochs}")
        if self.merge_every < 1:
            raise ValueError(
                f"merge_every must be >= 1, got {self.merge_every}")
        if self.block_epochs % self.merge_every != 0:
            raise ValueError(
                f"block_epochs={self.block_epochs} must be a multiple of "
                f"merge_every={self.merge_every} so every block ends on a "
                "Reduce boundary")
        if self.repartition_every is not None and (
            self.repartition_every < 1
            or self.repartition_every % self.merge_every != 0
        ):
            raise ValueError(
                f"repartition_every must be >= 1 (or None to disable) and "
                f"a multiple of merge_every={self.merge_every} — workers "
                "hold their subset for whole Reduce rounds; got "
                f"{self.repartition_every}")


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Periodic training checkpoints at Reduce boundaries (``train()`` /
    ``kg.fit(checkpoint_every=K, ckpt_dir=...)``).

    ``every`` counts epochs between snapshots; ``None`` saves only the
    final state.  The run's last epoch (including an early stop) is
    always checkpointed, so a resume can always continue.  Saves go
    through ``train/checkpoint.AsyncSaver`` by default — the loop pays the
    device-to-host copy, a daemon thread the disk I/O; ``synchronous=True``
    writes in line.

    The manifest records model name, seed, graph fingerprint, epoch, the
    loss history so far and :func:`resume_config` — everything
    ``kg.fit(resume=True)`` needs to continue bit-identically, in either
    package."""

    ckpt_dir: str
    every: Optional[int] = None
    keep: int = 3
    synchronous: bool = False

    def __post_init__(self):
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1 (or None), got {self.every}")


def resume_config(tcfg: KGConfig, cfg: "MapReduceConfig") -> dict:
    """The manifest fields a resume must match for bit-identity: every
    knob that shapes the training trajectory — partitioning, batching,
    schedule, paradigm/pipeline/strategy, and the scalar hyperparameters.
    The reference's dict, field for field: ``backend``, ``block_epochs``,
    ``merge_transport``, ``table_sharding`` and ``touched_capacity`` are
    absent, as there (each is proved not to change the trajectory)."""
    return {
        "paradigm": cfg.paradigm,
        "pipeline": cfg.pipeline,
        "n_workers": cfg.n_workers,
        "batch_size": cfg.batch_size,
        "partition": cfg.partition,
        "staleness": cfg.staleness,
        "strategy": cfg.strategy if cfg.paradigm == "sgd" else None,
        "merge_every": cfg.schedule.merge_every,
        "repartition_every": cfg.schedule.repartition_every,
        "margin": tcfg.margin,
        "norm": tcfg.norm,
        "learning_rate": tcfg.learning_rate,
        "normalize": tcfg.normalize,
        "sampling": tcfg.sampling,
    }


class _CheckpointWriter:
    """The training loop's checkpoint hook: owns the saver and the
    manifest fields every save shares; the loop calls ``due`` / ``save``
    at each boundary and ``finish`` at the end."""

    def __init__(self, cfg: CheckpointConfig, base_extra: dict):
        self.cfg = cfg
        self.base = base_extra
        self.saver = None if cfg.synchronous else checkpoint_lib.AsyncSaver()
        self.last_saved: Optional[int] = None

    def due(self, done: int, epochs: int, stopping: bool = False) -> bool:
        if done == self.last_saved:
            return False
        return (
            done == epochs
            or stopping
            or (self.cfg.every is not None and done % self.cfg.every == 0)
        )

    def save(self, done: int, params, history) -> None:
        extra = dict(self.base, epoch=done, loss_history=list(history))
        self.last_saved = done
        if self.saver is None:
            checkpoint_lib.save(self.cfg.ckpt_dir, done, params, extra=extra,
                                keep=self.cfg.keep)
        else:
            self.saver.save_async(self.cfg.ckpt_dir, done, params,
                                  extra=extra, keep=self.cfg.keep)

    def finish(self) -> None:
        if self.saver is not None:
            self.saver.wait()


@dataclasses.dataclass(frozen=True)
class MapReduceConfig:
    n_workers: int = 4
    paradigm: str = "sgd"           # 'sgd' | 'bgd'
    strategy: str = "average"       # merge_lib.STRATEGIES (sgd paradigm only)
    # the shard_map backend's dense SGD Reduce: 'psum' (all-reduces) or
    # 'allgather' (the full stacks, the vmap bits); the sparse transport
    # all-gathers its packed buffers under either
    reduce_impl: str = "psum"
    merge_transport: str = "dense"  # 'dense' | 'sparse' (module docstring)
    backend: str = "vmap"           # 'vmap' | 'shard_map' (module docstring)
    batch_size: int = 256
    # host partitioner (data/kg.PARTITIONERS): 'balanced' | 'stratified' |
    # 'degree' | 'overlap'
    partition: str = "balanced"
    model: str = "transe"           # kg_models registry name
    pipeline: str = "host"          # 'host' | 'device' (module docstring)
    schedule: EpochSchedule = EpochSchedule()
    # raise instead of warn when batch_size doesn't divide the worker split
    strict_batching: bool = False
    # device pipeline: the block takes ownership of the params dict it is
    # given — it empties the dict and drops each table as soon as the
    # block is done with it, so on the SGD paradigm a round's input tables
    # are freed once broadcast to the workers' copies.  PyTorch has no
    # buffer donation; this saves at most one copy of the tables, and the
    # tensors are never written, so results are bit-identical on and off
    # and a caller's tensors stay valid.  None = on.
    donate_params: Optional[bool] = None
    # 'replicated' | 'sharded' (module docstring; needs the sparse
    # transport)
    table_sharding: str = "replicated"
    # sparse transport: static per-round delta-buffer capacity override
    # (touched rows per worker per table).  None = the analytic
    # merge_lib.touched_capacity bound.  An override below the bound would
    # make pack_delta drop rows, so train() checks it against the bound and
    # raises before any epoch runs; the runtime overflow check
    # (delta_overflow) is the second seatbelt.
    touched_capacity: Optional[int] = None
    # bounded staleness S (module docstring): SGD on the device pipeline
    staleness: int = 0

    @property
    def partitioner(self) -> str:
        """Public alias of ``partition``."""
        return self.partition

    def __post_init__(self):
        if self.paradigm not in ("sgd", "bgd"):
            raise ValueError(f"bad paradigm {self.paradigm!r}")
        if self.paradigm == "sgd" and self.strategy not in merge_lib.STRATEGIES:
            raise ValueError(f"bad strategy {self.strategy!r}")
        if self.merge_transport not in ("dense", "sparse"):
            raise ValueError(f"bad merge_transport {self.merge_transport!r}")
        if self.table_sharding not in ("replicated", "sharded"):
            raise ValueError(f"bad table_sharding {self.table_sharding!r}")
        if self.table_sharding == "sharded" and self.merge_transport != "sparse":
            raise ValueError(
                "table_sharding='sharded' routes sparse delta buffers to "
                "their owning shards — it needs merge_transport='sparse' "
                "(the dense transport exchanges whole tables, which is the "
                "replicated layout by definition)")
        if self.touched_capacity is not None:
            if self.merge_transport != "sparse":
                raise ValueError(
                    "touched_capacity sizes the sparse transport's delta "
                    "buffers — set merge_transport='sparse' or drop it")
            if self.paradigm != "sgd":
                raise ValueError(
                    "touched_capacity is an SGD-paradigm knob (the BGD "
                    "sparse update sizes its buffers exactly from the "
                    "batch shape)")
            if self.touched_capacity < 1:
                raise ValueError(
                    f"touched_capacity must be >= 1 (or None for the "
                    f"analytic bound), got {self.touched_capacity}")
        if self.backend not in ("vmap", "shard_map"):
            raise ValueError(f"bad backend {self.backend!r}")
        if self.reduce_impl not in ("psum", "allgather"):
            raise ValueError(f"bad reduce_impl {self.reduce_impl!r}")
        if self.pipeline not in ("host", "device"):
            raise ValueError(f"bad pipeline {self.pipeline!r}")
        if self.partition not in kg_lib.PARTITIONERS:
            raise ValueError(
                f"bad partition {self.partition!r}; want one of "
                f"{tuple(kg_lib.PARTITIONERS)}")
        if (self.partition == "overlap"
                and self.schedule.repartition_every is not None):
            raise ValueError(
                "partition='overlap' cannot re-partition on device: the "
                "overlap-minimizing split is a host-side greedy stream, "
                "not a permutation the compiled pipeline can redraw — "
                "drop repartition_every or pick 'balanced'/'stratified'/"
                "'degree'")
        if self.staleness < 0:
            raise ValueError(
                f"staleness must be >= 0, got {self.staleness}")
        if self.staleness > 0 and (
            self.paradigm != "sgd" or self.pipeline != "device"
        ):
            raise ValueError(
                "staleness > 0 is the bounded-staleness SGD Reduce on the "
                "device pipeline (BGD's gradient Reduce has no local copies "
                "to go stale; the host loop Reduces synchronously every "
                "epoch) — set paradigm='sgd', pipeline='device'")
        if self.pipeline == "host" and (
            self.schedule.block_epochs != 1
            or self.schedule.merge_every != 1
            or self.schedule.repartition_every is not None
        ):
            raise ValueError(
                "EpochSchedule with block_epochs/merge_every != 1 or "
                "repartition_every set needs pipeline='device' — the host "
                "loop drives one epoch at a time with a Reduce per epoch "
                "on the partition it built at start")
        if self.schedule.merge_every > 1 and self.paradigm != "sgd":
            raise ValueError(
                "merge_every > 1 is an SGD-paradigm schedule (BGD has no "
                "Reduce merge to defer)")
        kg_models.get_model(self.model)      # raises on unknown name


def _resolve(cfg: MapReduceConfig, model: Optional[KGModel]) -> KGModel:
    return kg_models.get_model(model if model is not None else cfg.model)


def _check_mesh(cfg: MapReduceConfig, mesh, device=None) -> None:
    """The ``shard_map`` backend's mesh: present, a ``DeviceMesh`` with a
    ``"workers"`` dimension over which ``cfg.n_workers`` divides, of the
    tensors' device type (``parallel.util.check_mesh``)."""
    if mesh is None:
        raise ValueError("shard_map backend needs a mesh")
    par.check_mesh(mesh, device, cfg.n_workers)


# ---------------------------------------------------------------------------
# SGD paradigm
# ---------------------------------------------------------------------------

def _stats_for_role(stats: EpochStats, role: str):
    if role == "ent":
        return stats.ent_count, stats.ent_loss
    return stats.rel_count, stats.rel_loss


def _broadcast(params: Params, W: int) -> Params:
    """W stacked copies ``(W, N, k)`` of every table, one per worker."""
    return {name: p.unsqueeze(0).repeat(W, *(1,) * p.dim())
            for name, p in params.items()}


def _merge_tables_stacked(
    model: KGModel, strategy: str, stacked: Params, stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]],
) -> Params:
    """Reduce every table of the stacked (leading worker axis) params,
    routed by the model's entity/relation roles, in sorted name order."""
    roles = model.param_roles()
    out = {}
    for name in sorted(stacked):
        count, loss = _stats_for_role(stats, roles[name])
        out[name] = merge_lib.merge_stacked(
            strategy, stacked[name], count, loss, stats.mean_loss,
            None if priorities is None else priorities[name])
    return out


def _delta_capacity(
    cfg: MapReduceConfig, n_rows: int, n_steps: int, k_epochs: int, role: str
) -> int:
    """The static delta-buffer capacity of one table: the analytic
    ``merge_lib.touched_capacity`` bound, or the user override (checked
    against the bound by :func:`_check_touched_capacity` before any epoch
    runs; clamped to the table like the bound)."""
    if cfg.touched_capacity is not None:
        return int(min(n_rows, cfg.touched_capacity))
    return merge_lib.touched_capacity(
        n_rows, cfg.batch_size, n_steps, k_epochs, role)


def _check_touched_capacity(
    cfg: MapReduceConfig, tcfg: KGConfig, model: KGModel, n_steps: int
) -> None:
    """Raise at ``train()`` time when a capacity override is below the
    analytic touched-rows bound for any table role: ``pack_delta`` would
    drop the overflow rows otherwise.  (``MapReduceConfig`` allows an
    override only on the SGD sparse transport.)"""
    if cfg.touched_capacity is None:
        return
    rows = {"ent": tcfg.n_entities, "rel": tcfg.n_relations}
    K = cfg.schedule.merge_every
    for role in sorted(set(model.param_roles().values())):
        n_rows = rows[role]
        bound = merge_lib.touched_capacity(
            n_rows, cfg.batch_size, n_steps, K, role)
        if min(n_rows, cfg.touched_capacity) < bound:
            raise ValueError(
                f"touched_capacity={cfg.touched_capacity} is below the "
                f"analytic bound {bound} for {role!r}-role tables "
                f"({n_steps} steps x batch_size {cfg.batch_size} x "
                f"merge_every {K}): pack_delta would silently drop touched "
                "rows and corrupt the merge.  Raise the override or pass "
                "None to use the bound.")


def _virgin_repeats(tcfg: KGConfig, n_steps: int, k_epochs: int) -> int:
    """How many times a row *no* step touched has been through the model's
    constraint projection by Reduce time: once per epoch start
    (``normalize='epoch'``), once per step (``'step'``), never
    (``'none'``)."""
    if tcfg.normalize == "epoch":
        return k_epochs
    if tcfg.normalize == "step":
        return k_epochs * n_steps
    return 0


def _merge_tables_sparse_stacked(
    model: KGModel,
    cfg: MapReduceConfig,
    stacked: Params,
    stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]],
    base: Params,                # the shared round-input params
    tcfg: KGConfig,
    n_steps: int,
    k_epochs: int,
) -> tuple:
    """Sparse-transport Reduce of the stacked params: pack each worker's
    touched rows into static-capacity delta buffers, merge only the union
    of the candidate rows, scatter them into the untouched rows' merged
    value — bit-identical to :func:`_merge_tables_stacked`, table by table
    in sorted name order.

    Returns ``(params, overflow)``: ``overflow`` is the round's worst
    per-table excess of touched rows over the capacity, an int64 device
    scalar (0 under the analytic bound); the training drivers raise on a
    positive value, since ``pack_delta`` dropped that many rows' updates."""
    m = _virgin_repeats(tcfg, n_steps, k_epochs)
    out = {}
    overflow, packed = _pack_tables(model, cfg, stacked, stats, n_steps,
                                    k_epochs)
    for name, deltas in packed.items():
        args = (cfg.strategy, *deltas, stats.mean_loss, stacked[name][0],
                base[name],
                lambda rows, name=name: model.normalize_rows(name, rows), m,
                None if priorities is None else priorities[name])
        if cfg.table_sharding == "sharded":
            out[name] = merge_lib.merge_sparse_sharded_stacked(
                *args, n_shards=cfg.n_workers)
        else:
            out[name] = merge_lib.merge_sparse_stacked(*args)
    return out, overflow


def _pack_tables(model: KGModel, cfg: MapReduceConfig, stacked: Params,
                 stats: EpochStats, n_steps: int, k_epochs: int) -> tuple:
    """``(overflow, {name: (idx, vals, cnt, lss)})``: every table's packed
    per-worker delta buffers (:func:`merge_lib.pack_delta`), in sorted name
    order, and the round's worst capacity excess over them."""
    roles = model.param_roles()
    overflow = torch.zeros((), dtype=torch.int64,
                           device=stats.ent_count.device)
    packed = {}
    for name in sorted(stacked):
        count, loss = _stats_for_role(stats, roles[name])
        n_rows = stacked[name].shape[1]
        cap = _delta_capacity(cfg, n_rows, n_steps, k_epochs, roles[name])
        overflow = torch.maximum(overflow,
                                 merge_lib.delta_overflow(count, cap))
        packed[name] = merge_lib.pack_delta(stacked[name], count, loss, cap,
                                            n_rows)
    return overflow, packed


def _merge_tables_stale_stacked(
    model: KGModel, strategy: str, stacked: Params, stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]], base: Params,
) -> Params:
    """The bounded-staleness Reduce of the stacked worker copies into the
    global view ``base``, table by table in sorted name order, each
    participation-masked (:func:`merge_lib.merge_stacked_stale`): per row
    only this round's touchers take part, and rows nobody touched keep the
    global view."""
    roles = model.param_roles()
    out = {}
    for name in sorted(stacked):
        count, loss = _stats_for_role(stats, roles[name])
        out[name] = merge_lib.merge_stacked_stale(
            strategy, stacked[name], count, loss, stats.mean_loss,
            base[name], None if priorities is None else priorities[name])
    return out


def _merge_tables_stale_sparse(
    model: KGModel,
    cfg: MapReduceConfig,
    stacked: Params,
    stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]],
    base: Params,                # the global view being merged into
    n_steps: int,
    k_epochs: int,
) -> tuple:
    """The sparse-transport bounded-staleness Reduce: each worker's touched
    rows packed, the candidate union stale-merged into the global view
    (shard by shard under ``table_sharding="sharded"``) — bit-identical to
    :func:`_merge_tables_stale_stacked`.  No virgin rows are rebuilt: a
    worker that did not touch a row takes no part in it, so the transport
    needs no shared round input.  Returns ``(params, overflow)`` as
    :func:`_merge_tables_sparse_stacked` does."""
    out = {}
    overflow, packed = _pack_tables(model, cfg, stacked, stats, n_steps,
                                    k_epochs)
    for name, deltas in packed.items():
        args = (cfg.strategy, *deltas, stats.mean_loss, base[name],
                None if priorities is None else priorities[name])
        if cfg.table_sharding == "sharded":
            out[name] = merge_lib.merge_sparse_stale_sharded_stacked(
                *args, n_shards=cfg.n_workers)
        else:
            out[name] = merge_lib.merge_sparse_stale(*args)
    return out, overflow


def sgd_epoch_vmap(
    params: Params,
    pos: torch.Tensor,               # (W, S, B, 3)
    neg: torch.Tensor,               # (W, S, B, 3)
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    priorities: Optional[Dict[str, torch.Tensor]] = None,
    model: Optional[KGModel] = None,
    check_ids: bool = True,
    *,
    with_overflow: bool = False,
) -> tuple:
    """Map (local epochs of all W workers from the shared params, side by
    side on stacked copies) + Reduce (stacked merge): ``(params, loss)``,
    over the sparse transport when ``cfg.merge_transport == "sparse"``.
    ``check_ids=False``: the ids are proved in range, and the step makes
    no host sync (``KGModel._pairs_and_grads``).  ``with_overflow``
    appends the round's capacity overflow (an int64 device scalar, 0 on
    the dense transport): ``(params, loss, overflow)``."""
    model = _resolve(cfg, model)
    sparse = cfg.merge_transport == "sparse"
    stacked, stats = model.run_epoch(
        _broadcast(params, pos.shape[0]), pos, neg, tcfg, sparse_apply=sparse,
        touch_losses=cfg.strategy == "miniloss_perkey", check_ids=check_ids)
    if sparse:
        merged, overflow = _merge_tables_sparse_stacked(
            model, cfg, stacked, stats, priorities, params, tcfg,
            pos.shape[1], 1)
    else:
        merged = _merge_tables_stacked(model, cfg.strategy, stacked, stats,
                                       priorities)
        overflow = torch.zeros((), dtype=torch.int64, device=pos.device)
    loss = merge_lib.worker_mean(stats.mean_loss)
    if with_overflow:
        return merged, loss, overflow
    return merged, loss


def _merge_tables_collective(
    model: KGModel, cfg: MapReduceConfig, local: Params, stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]], mesh, lo: int,
) -> Params:
    """The ``shard_map`` counterpart of :func:`_merge_tables_stacked`:
    this rank's ``(W/M, N, k)`` copies Reduced by collectives, table by
    table in sorted name order, each by ``cfg.reduce_impl``
    (``merge_lib.merge_allgather``, the vmap bits, or
    ``merge_lib.merge_collective``).  ``priorities`` are every worker's
    ``(W, N)``; the psum Reduce takes this rank's rows from ``lo``."""
    roles = model.param_roles()
    hi = lo + stats.mean_loss.shape[0]
    out = {}
    for name in sorted(local):
        count, loss = _stats_for_role(stats, roles[name])
        pri = None if priorities is None else priorities[name]
        if cfg.reduce_impl == "psum":
            out[name] = merge_lib.merge_collective(
                cfg.strategy, local[name], count, loss, stats.mean_loss,
                mesh, None if pri is None else pri[lo:hi],
                n_workers=cfg.n_workers, lo=lo)
        else:
            out[name] = merge_lib.merge_allgather(
                cfg.strategy, local[name], count, loss, stats.mean_loss,
                mesh, pri)
    return out


def _merge_tables_sparse_collective(
    model: KGModel,
    cfg: MapReduceConfig,
    local: Params,               # this rank's (W/M, N, k) copies
    stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]],
    base: Params,                # the shared round-input params
    tcfg: KGConfig,
    n_steps: int,
    k_epochs: int,
    mesh,
) -> tuple:
    """The sparse-transport Reduce over a mesh: each rank packs its
    workers' touched rows, the packed buffers are all-gathered
    (``parallel.util.all_gather_deltas``, the transport's only
    cross-worker traffic) and every rank replays the stacked sparse merge
    (``merge_lib.merge_sparse_stacked``) on the full ``(W, C, ...)``
    buffers — or, under ``table_sharding="sharded"``, merges only the
    candidate blocks its workers own and all-gathers the merged blocks
    (``merge_lib.merge_sparse_sharded_collective``): the vmap backend's
    bits either way, whatever ``cfg.reduce_impl`` says (there is nothing
    to psum).  Returns ``(params, overflow)`` with the overflow maxed over
    the ranks."""
    m = _virgin_repeats(tcfg, n_steps, k_epochs)
    wl = par.all_gather(stats.mean_loss, mesh)                   # (W,)
    overflow, packed = _pack_tables(model, cfg, local, stats, n_steps,
                                    k_epochs)
    out = {}
    for name, deltas in packed.items():
        idx, vals, cnt, lss = par.all_gather_deltas(deltas, mesh)
        args = (cfg.strategy, idx, vals, cnt, lss, wl, local[name][0],
                base[name],
                lambda rows, name=name: model.normalize_rows(name, rows), m,
                None if priorities is None else priorities[name])
        if cfg.table_sharding == "sharded":
            out[name] = merge_lib.merge_sparse_sharded_collective(
                *args, mesh=mesh)
        else:
            out[name] = merge_lib.merge_sparse_stacked(*args)
    return out, par.all_reduce(overflow, mesh, "max")


def _merge_tables_stale_collective(
    model: KGModel,
    cfg: MapReduceConfig,
    local: Params,               # this rank's (W/M, N, k) worker copies
    stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]],
    base: Params,                # the global view being merged into
    n_steps: int,
    k_epochs: int,
    mesh,
) -> tuple:
    """The bounded-staleness Reduce over a mesh (port of the reference's
    ``_merge_tables_stale_collective``), table by table in sorted name
    order.  Sparse transport: the packed buffers are all-gathered and
    every rank replays the stale merge, shard-routed under
    ``table_sharding="sharded"`` (``merge_lib.merge_sparse_stale_
    collective``).  Dense transport: the tables and touch stats are
    all-gathered and every rank replays ``merge_lib.merge_stacked_stale``;
    there is no psum winner-select, since the participation masks need
    every toucher's row.  The vmap backend's bits either way.  Returns
    ``(params, overflow)`` with the overflow maxed over the ranks (0 on
    the dense transport)."""
    wl = par.all_gather(stats.mean_loss, mesh)                   # (W,)
    gather = lambda t: None if t is None else par.all_gather(t, mesh)
    out = {}
    if cfg.merge_transport == "sparse":
        overflow, packed = _pack_tables(model, cfg, local, stats, n_steps,
                                        k_epochs)
        for name, deltas in packed.items():
            idx, vals, cnt, lss = par.all_gather_deltas(deltas, mesh)
            out[name] = merge_lib.merge_sparse_stale_collective(
                cfg.strategy, idx, vals, cnt, lss, wl, base[name],
                None if priorities is None else priorities[name],
                mesh=mesh, sharded=cfg.table_sharding == "sharded")
        return out, par.all_reduce(overflow, mesh, "max")
    roles = model.param_roles()
    for name in sorted(local):
        count, loss = _stats_for_role(stats, roles[name])
        out[name] = merge_lib.merge_stacked_stale(
            cfg.strategy, gather(local[name]), gather(count), gather(loss),
            wl, base[name],
            None if priorities is None else priorities[name])
    return out, torch.zeros((), dtype=torch.int64, device=wl.device)


def _gathered_mean(local_losses: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over all W workers of per-worker losses ``(W/M, ...)``:
    all-gathered in rank order, then summed in worker order
    (``merge_lib.worker_mean``), so the loss is the vmap backend's bits
    under every Reduce (the reference's ``pmean`` agrees only to
    tolerance)."""
    return merge_lib.worker_mean(par.all_gather(local_losses, mesh))


def sgd_epoch_shard(
    params: Params,
    pos: torch.Tensor,               # (W, S, B, 3) every worker's batches
    neg: torch.Tensor,               # (W, S, B, 3)
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    priorities: Optional[Dict[str, torch.Tensor]],
    mesh,
    model: Optional[KGModel] = None,
    check_ids: bool = True,
    *,
    with_overflow: bool = False,
) -> tuple:
    """Map/Reduce over the mesh (port of the reference's
    ``sgd_epoch_shard``): this rank runs its ``W/M`` workers' local epochs
    side by side on stacked copies (the rows ``[lo, hi)`` of ``pos`` and
    ``neg``), then Reduces by collectives (:func:`_merge_tables_collective`
    or, on the sparse transport, :func:`_merge_tables_sparse_collective`);
    the loss is :func:`_gathered_mean`'s.  Every rank calls it and
    returns the same ``(params, loss)`` (``, overflow`` with
    ``with_overflow``)."""
    model = _resolve(cfg, model)
    lo, hi = par.local_workers(mesh, cfg.n_workers)
    sparse = cfg.merge_transport == "sparse"
    local, stats = model.run_epoch(
        _broadcast(params, hi - lo), pos[lo:hi], neg[lo:hi], tcfg,
        sparse_apply=sparse, touch_losses=cfg.strategy == "miniloss_perkey",
        check_ids=check_ids)
    if sparse:
        merged, overflow = _merge_tables_sparse_collective(
            model, cfg, local, stats, priorities, params, tcfg,
            pos.shape[1], 1, mesh)
    else:
        merged = _merge_tables_collective(model, cfg, local, stats,
                                          priorities, mesh, lo)
        overflow = torch.zeros((), dtype=torch.int64, device=pos.device)
    loss = _gathered_mean(stats.mean_loss, mesh)
    if with_overflow:
        return merged, loss, overflow
    return merged, loss


# ---------------------------------------------------------------------------
# BGD paradigm
# ---------------------------------------------------------------------------

def _bgd_candidate_ids(pos_b: torch.Tensor, neg_b: torch.Tensor, role: str,
                       n_rows: int) -> torch.Tensor:
    """The sorted union of the rows one BGD step can reference, in a
    vector of static size padded with ``n_rows``: positive and corrupted
    heads and tails (entity-role tables) or the batch's relations
    (relation-role tables), over all W workers of a ``(W, B, 3)`` step."""
    if role == "ent":
        ids = torch.cat([pos_b[..., 0], pos_b[..., 2], neg_b[..., 0],
                         neg_b[..., 2]], dim=-1)
    else:
        ids = torch.cat([pos_b[..., 1], neg_b[..., 1]], dim=-1)
    flat = ids.reshape(-1).long()
    return merge_lib.sized_unique(flat, int(min(n_rows, flat.numel())) + 1,
                                  n_rows)


def _bgd_sparse_update_stacked(
    model: KGModel, cfg: MapReduceConfig, tcfg: KGConfig, params: Params,
    grads: Params, pos_b: torch.Tensor, neg_b: torch.Tensor,
) -> Params:
    """Sparse BGD Reduce: the workers' gradients are exactly ``+0.0`` at
    rows no batch references, so the gradient mean and the update
    restricted to the step's candidate rows give the dense update's bits
    (``p - lr · 0.0`` is ``p``).  Under ``table_sharding="sharded"`` each
    shard updates the candidates it owns (:func:`merge_lib.own_candidates`),
    one shard after another: the mean and the update never mix rows, so
    the result is the same bits."""
    roles = model.param_roles()
    out = {}
    for name, table in params.items():
        n_rows = table.shape[0]
        cand = _bgd_candidate_ids(pos_b, neg_b, roles[name], n_rows)

        def update(ids, table=table, grad=grads[name]):
            gc = merge_lib.worker_mean(merge_lib.take_fill(grad, ids, 1))
            pc = merge_lib.take_fill(table, ids, 0)
            # apply_gradients' update on the candidate rows
            return ids, pc - tcfg.learning_rate * gc

        if cfg.table_sharding == "sharded":
            R = merge_lib.shard_rows(n_rows, cfg.n_workers)
            out[name] = merge_lib.scatter_blocks(table.clone(), [
                update(merge_lib.own_candidates(cand, s * R, R, n_rows))
                for s in range(cfg.n_workers)])
        else:
            out[name] = merge_lib.apply_delta(table, *update(cand))
    return out


def bgd_epoch_vmap(
    params: Params,
    pos: torch.Tensor,               # (W, S, B, 3)
    neg: torch.Tensor,
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    model: Optional[KGModel] = None,
    check_ids: bool = True,
) -> tuple:
    """Per step: Map = per-worker gradients, Reduce = their mean, one global
    update (on the sparse transport, on the step's candidate rows only:
    :func:`_bgd_sparse_update_stacked`).  Mathematically single-thread
    minibatch SGD on the W·B-sized union batch.  Returns ``(params,
    loss)``; ``check_ids`` as in :func:`sgd_epoch_vmap`."""
    model = _resolve(cfg, model)
    if tcfg.normalize == "epoch":
        params = model.normalize(params)
    losses = []
    for s in range(pos.shape[1]):
        _, loss, grads = model._pairs_and_grads(
            params, pos[:, s], neg[:, s], tcfg, shared=True,
            check_ids=check_ids)
        if cfg.merge_transport == "sparse":
            params = _bgd_sparse_update_stacked(
                model, cfg, tcfg, params, grads, pos[:, s], neg[:, s])
        else:
            grads = {name: merge_lib.worker_mean(g)
                     for name, g in grads.items()}
            params = apply_gradients(params, grads, tcfg.learning_rate)
        if tcfg.normalize == "step":
            params = model.normalize(params)
        losses.append(loss)
    # per step the workers' mean of their step losses, then the mean over
    # the steps, each sum in an order fixed on every device
    step_loss = merge_lib.worker_mean(torch.stack(losses).transpose(0, 1))
    return params, pairwise_mean(step_loss, 0)


def _bgd_sparse_update_collective(
    model: KGModel, cfg: MapReduceConfig, tcfg: KGConfig, params: Params,
    grads: Params, pos_b: torch.Tensor, neg_b: torch.Tensor, mesh,
) -> Params:
    """Sparse BGD Reduce over the mesh: each rank gathers its workers'
    gradient rows at its own step's candidate ids, the ids and rows are
    all-gathered, and every rank replays the stacked mean and update on
    the union — :func:`_bgd_sparse_update_stacked`'s bits: a worker's
    gradient at a row no batch of its references is exactly ``+0.0``,
    which is what the lookup fills where a rank did not list the row.
    Under ``table_sharding="sharded"`` each rank updates only the
    candidates its workers own (``merge_lib.own_candidates``) and the
    updated blocks are all-gathered, ids and rows
    (``merge_lib.own_blocks_collective``): the same bits."""
    roles = model.param_roles()
    Wl = pos_b.shape[0]
    W = cfg.n_workers
    out = {}
    for name, table in params.items():
        n_rows = table.shape[0]
        mine = _bgd_candidate_ids(pos_b, neg_b, roles[name], n_rows)
        gvals = merge_lib.take_fill(grads[name], mine, 1)   # (W/M, U, k)
        idx = par.all_gather(mine[None], mesh).repeat_interleave(Wl, 0)
        vals = par.all_gather(gvals, mesh)                  # (W, U, k)
        cand = merge_lib.sparse_candidates(idx, n_rows)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)

        def update(ids, table=table):
            gc = merge_lib.worker_mean(
                merge_lib.lookup_rows(idx, vals, ids, zero, n_rows))
            pc = merge_lib.take_fill(table, ids, 0)
            return ids, pc - tcfg.learning_rate * gc

        if cfg.table_sharding == "sharded":
            R = merge_lib.shard_rows(n_rows, W)
            out[name] = merge_lib.put_drop_(
                table.clone(), *merge_lib.own_blocks_collective(
                    lambda s: update(merge_lib.own_candidates(
                        cand, s * R, R, n_rows)), W, mesh))
        else:
            out[name] = merge_lib.apply_delta(table, *update(cand))
    return out


def _bgd_epoch_collective(
    model: KGModel, cfg: MapReduceConfig, tcfg: KGConfig, params: Params,
    pos: torch.Tensor,               # (W/M, S, B, 3) this rank's workers
    neg: torch.Tensor, mesh, check_ids: bool = True,
) -> tuple:
    """One BGD epoch on this rank's workers: per step their gradients,
    the Reduce, one global update.  The dense Reduce is the reference's
    ``pmean`` of the gradients every step: each rank sums its own workers
    in worker order and an all-reduce adds the ranks' sums (the vmap bits
    at M = 1, within rtol 1e-4 / atol 1e-5 at M > 1); the sparse one is
    :func:`_bgd_sparse_update_collective` (the vmap bits).  The epoch's
    loss all-gathers the per-worker step losses once
    (:func:`_gathered_mean`)."""
    if tcfg.normalize == "epoch":
        params = model.normalize(params)
    losses = []
    for s in range(pos.shape[1]):
        _, loss, grads = model._pairs_and_grads(
            params, pos[:, s], neg[:, s], tcfg, shared=True,
            check_ids=check_ids)
        if cfg.merge_transport == "sparse":
            params = _bgd_sparse_update_collective(
                model, cfg, tcfg, params, grads, pos[:, s], neg[:, s], mesh)
        else:
            grads = {name: exact_div(par.all_reduce(
                         merge_lib.worker_sum(g), mesh), cfg.n_workers)
                     for name, g in grads.items()}
            params = apply_gradients(params, grads, tcfg.learning_rate)
        if tcfg.normalize == "step":
            params = model.normalize(params)
        losses.append(loss)
    step_loss = _gathered_mean(torch.stack(losses).transpose(0, 1), mesh)
    return params, pairwise_mean(step_loss, 0)


def bgd_epoch_shard(
    params: Params,
    pos: torch.Tensor,               # (W, S, B, 3) every worker's batches
    neg: torch.Tensor,
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    mesh,
    model: Optional[KGModel] = None,
    check_ids: bool = True,
) -> tuple:
    """:func:`_bgd_epoch_collective` on this rank's rows ``[lo, hi)`` of
    ``pos`` and ``neg``; every rank returns the same ``(params, loss)``."""
    model = _resolve(cfg, model)
    lo, hi = par.local_workers(mesh, cfg.n_workers)
    return _bgd_epoch_collective(model, cfg, tcfg, params, pos[lo:hi],
                                 neg[lo:hi], mesh, check_ids)


# ---------------------------------------------------------------------------
# Epoch dispatcher + host-side training loop
# ---------------------------------------------------------------------------

def make_epoch_fn(
    cfg: MapReduceConfig, tcfg: KGConfig, model: Optional[KGModel] = None,
    check_ids: bool = True, *, with_overflow: bool = False, mesh=None,
) -> Callable:
    """``epoch_fn(params, pos, neg, priorities) -> (params, loss)`` for the
    configured paradigm and backend (BGD ignores ``priorities``), or
    ``(params, loss, overflow)`` with ``with_overflow`` (BGD's is a
    constant 0: its sparse buffers are sized exactly from the batch);
    ``check_ids`` as in :func:`sgd_epoch_vmap`.  The ``shard_map``
    backend needs ``mesh`` and takes every worker's ``pos`` / ``neg``."""
    model = _resolve(cfg, model)
    shard = cfg.backend == "shard_map"
    if shard:
        _check_mesh(cfg, mesh)
    if cfg.paradigm == "sgd":
        if shard:
            return lambda p, pos, neg, pri: sgd_epoch_shard(
                p, pos, neg, cfg, tcfg, pri, mesh, model, check_ids,
                with_overflow=with_overflow)
        return lambda p, pos, neg, pri: sgd_epoch_vmap(
            p, pos, neg, cfg, tcfg, pri, model, check_ids,
            with_overflow=with_overflow)

    def bgd(p, pos, neg, pri):
        if shard:
            out = bgd_epoch_shard(p, pos, neg, cfg, tcfg, mesh, model,
                                  check_ids)
        else:
            out = bgd_epoch_vmap(p, pos, neg, cfg, tcfg, model, check_ids)
        if with_overflow:
            out += (torch.zeros((), dtype=torch.int64, device=pos.device),)
        return out

    return bgd


# ---------------------------------------------------------------------------
# Block driver (the 'device' pipeline)
# ---------------------------------------------------------------------------

def _zero_stats(tcfg: KGConfig, W: int, touch_losses: bool,
                device) -> EpochStats:
    """Stacked all-zero stats, the start of a round's sum over its K local
    epochs (the per-key loss sums ``None`` without ``touch_losses``)."""
    zeros = lambda *shape: torch.zeros(shape, dtype=tcfg.dtype,
                                       device=device)
    E, R = tcfg.n_entities, tcfg.n_relations
    return EpochStats(
        mean_loss=zeros(W), ent_count=zeros(W, E),
        ent_loss=zeros(W, E) if touch_losses else None,
        rel_count=zeros(W, R),
        rel_loss=zeros(W, R) if touch_losses else None)


def _add_stats(a: EpochStats, b: EpochStats) -> EpochStats:
    return EpochStats(*(
        None if x is None else x + y
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(EpochStats))))


def _check_ids(trip, tcfg: KGConfig, what: str) -> None:
    """Raise unless every ``(..., 3)`` triplet id lies inside its table:
    the one range check of a training run, on the host (the kernels then
    skip theirs, ``check_ids=False``)."""
    t = np.asarray(trip)
    if t.size == 0:
        return
    ent, rel = t[..., [0, 2]], t[..., 1]
    if ent.min() < 0 or ent.max() >= tcfg.n_entities or rel.min() < 0 \
            or rel.max() >= tcfg.n_relations:
        raise IndexError(
            f"{what} holds entity ids in [{ent.min()}, {ent.max()}] and "
            f"relation ids in [{rel.min()}, {rel.max()}], outside the "
            f"{tcfg.n_entities} entity / {tcfg.n_relations} relation rows")


def _injected(draw, tcfg: KGConfig, device):
    """An epoch's draws handed in through ``train(draws=...)``: ids checked
    on the host, then moved to ``device``."""
    *trips, pri = draw
    out = []
    for i, t in enumerate(trips):
        _check_ids(t, tcfg, "injected negatives" if i == len(trips) - 1
                   else "injected batches")
        out.append(torch.tensor(np.asarray(t, np.int32), device=device))
    pri = None if pri is None else {
        name: torch.tensor(np.asarray(v), device=device)
        for name, v in pri.items()}
    return (*out, pri)


def make_block_fn(
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    partitioned: torch.Tensor,   # (W, N_w, 3) int32 on the run's device
    *,
    model: Optional[KGModel] = None,
    head_prob: Optional[torch.Tensor] = None,
    seed: int = 0,
    donate: bool = False,
    strata: Optional[torch.Tensor] = None,
    draws: Optional[Callable[[int], DeviceDraws]] = None,
    with_overflow: bool = False,
    stale_offsets=None,
    update_mask: Optional[Dict[str, object]] = None,
    mesh=None,
) -> Callable:
    """``block_fn(params, epoch_ids) -> (params, losses)``: the device
    pipeline's block of epochs (port of the reference's ``make_block_fn``,
    either backend, either transport), or ``(params, losses, overflow)``
    with ``with_overflow``: the block's worst sparse-transport capacity
    excess, an int64 device scalar (a constant 0 under BGD and the dense
    transport), which the caller reads at the block's end.

    ``epoch_ids`` are absolute epoch indices, host integers (a ``range``),
    as many as a multiple of ``schedule.merge_every``.  Every epoch's
    batches (``data/kg.device_epoch_batches`` of ``fold_in(k_data, e)``),
    negatives (``negative.device_draws`` of ``fold_in(fold_in(k_neg, e),
    w)`` per worker) and, at the end of a merge round, the ``random``
    strategy's priorities (per table in sorted name order ``i``, per
    worker ``w``: ``uniform(fold_in(fold_in(fold_in(k_merge, e_last), i),
    w))``) are drawn on the partition's device (``core/keys.py``), so the
    block makes no host sync and its results are the same bits for any
    block split.  ``losses`` is the ``(L,)`` per-epoch mean loss, a device
    tensor: the caller decides when to read it.

    SGD: each merge round broadcasts the shared params to W stacked
    copies; each worker runs K local epochs on its copy (``normalize=
    'epoch'`` at each epoch's start), the per-key stats summed over the K
    epochs with ``mean_loss / K``; one Reduce ends the round.  On the
    sparse transport the round input stays alive to its Reduce, which
    rebuilds the rows a worker did not touch from it
    (:func:`_merge_tables_sparse_stacked`).  BGD: one
    :func:`bgd_epoch_vmap` per epoch.

    ``schedule.repartition_every=M``: the partition in effect for the
    whole block is re-partition round ``epoch_ids[0] // M``
    (``data/kg.device_repartition``, stratified by ``strata`` when given),
    drawn once per call — so a block may not cross a round boundary
    (``train()`` slices blocks there).

    Bounded staleness (``cfg.staleness=S > 0``, SGD): the block's state,
    taken and returned in place of ``params``, is ``(global_view,
    worker_locals)``, the locals stacked ``(W, N, k)``.  Each round worker
    ``w`` adopts the global view when its absolute round ``r = e // K``
    is 0 or ``(r + o_w) % (S + 1) == 0`` (``o_w`` from
    ``keys.stale_offsets``; ``stale_offsets``, ``(W,)`` ints, replaces
    them, for tests), and keeps its local copy otherwise; then K local
    epochs, and one participation-masked Reduce into the global view
    (:func:`_merge_tables_stale_stacked`, or
    :func:`_merge_tables_stale_sparse`).  The gate reads the absolute
    round, so block splits change no bit.

    ``donate``: the block empties the params dict it is given and drops
    its references as soon as it can (``MapReduceConfig.donate_params``;
    on the sparse SGD transport the round input lives to the Reduce, so
    donation frees nothing early there).  On the stale state it empties
    both dicts: the input locals are freed once the first round has built
    its copies from them, and the input global view at the first Reduce.
    ``draws(epoch)``, when given, returns that epoch's batches, negatives
    and (at a round's last epoch, ``random`` strategy) priorities as numpy
    arrays in place of the block's own (tests; a host copy per epoch).

    ``update_mask`` (one bool row mask per table, numpy or tensors; the
    online tier's masked fine-tune) freezes every row whose bit is False
    bitwise: the compact step writes frozen candidate rows back unchanged,
    the projections leave them alone (``KGModel.run_epoch``), and each
    Reduce's output is clamped back to the round input on them
    (``clamp_frozen``), so frozen rows stay the initial params' bytes
    while free rows train as they would in an unmasked run of the same
    draws.  It needs the SGD paradigm's sparse transport with
    ``staleness == 0``; the masks are put on the partition's device once,
    so the block stays free of host syncs.

    ``cfg.backend == "shard_map"`` (``mesh`` given; every rank calls the
    block): ``partitioned`` is this rank's ``(W/M, N_w, 3)`` workers
    ``[lo, hi)``, whose batches and negatives are drawn from their global
    worker ids, so each is the vmap worker's bits; a re-partition round
    all-gathers the shards once and takes this rank's rows of the same
    global permutation; each Reduce is a collective
    (:func:`_merge_tables_collective`,
    :func:`_merge_tables_sparse_collective`, BGD's
    :func:`_bgd_epoch_collective`), and the block's losses are all-gathered
    once at its end.  Nothing else syncs with the host.  Under bounded
    staleness the locals of the state are this rank's ``(W/M, N, k)``
    workers' copies; each worker's refresh phase is the one the vmap
    backend draws for its global worker id, and the stale Reduce is
    :func:`_merge_tables_stale_collective`.  Under ``table_sharding=
    "sharded"`` the params (the stale state's global view) are taken and
    returned at rest (:func:`resting_layout`): each dividing entity-role
    table as the row blocks of this rank's workers, all-gathered whole at
    the block's start, so the Map sees whole tables, and cut back at its
    end."""
    model = _resolve(cfg, model)
    W, B, K = cfg.n_workers, cfg.batch_size, cfg.schedule.merge_every
    M, S = cfg.schedule.repartition_every, cfg.staleness
    E, dev = tcfg.n_entities, partitioned.device
    shard = cfg.backend == "shard_map"
    lo, hi = 0, W
    if shard:
        _check_mesh(cfg, mesh, dev)
        lo, hi = par.local_workers(mesh, W)
    if update_mask is not None:
        if (cfg.paradigm != "sgd" or cfg.merge_transport != "sparse"
                or S > 0):
            raise ValueError(
                "update_mask (the masked fine-tune) requires the SGD "
                "paradigm with merge_transport='sparse' and staleness=0 — "
                f"got paradigm={cfg.paradigm!r}, "
                f"merge_transport={cfg.merge_transport!r}, staleness={S}")
        update_mask = {name: torch.as_tensor(m, dtype=torch.bool, device=dev)
                       for name, m in update_mask.items()}
    k_data, k_neg, k_merge, k_part = keys_lib.device_keys(seed)
    if S > 0:
        offsets = (keys_lib.stale_offsets(keys_lib.stale_key(seed), W, S,
                                          dev)
                   if stale_offsets is None else
                   torch.as_tensor(np.asarray(stale_offsets, np.int64),
                                   device=dev))[lo:hi]
    layout = resting_layout(cfg, tcfg, model) if shard else None
    touch_losses = cfg.strategy == "miniloss_perkey"
    sparse = cfg.merge_transport == "sparse"
    n_steps = partitioned.shape[1] // B
    rows = {"ent": tcfg.n_entities, "rel": tcfg.n_relations}
    roles = model.param_roles()
    workers = torch.arange(lo, hi, device=dev)      # this rank's, global ids
    all_workers = torch.arange(W, device=dev)

    def block_part(epoch_ids: list) -> torch.Tensor:
        if M is None:
            return partitioned
        r = epoch_ids[0] // M
        if epoch_ids[-1] // M != r:
            raise ValueError(
                f"epochs {epoch_ids[0]}..{epoch_ids[-1]} cross a "
                f"re-partition boundary (repartition_every={M}): slice the "
                "block there")
        if not shard:
            return kg_lib.device_repartition(
                keys_lib.fold_in(k_part, r), partitioned, r, strata)
        if r == 0:                  # round 0 is the original partition
            return partitioned
        full = par.all_gather(partitioned, mesh)
        return kg_lib.device_repartition(
            keys_lib.fold_in(k_part, r), full, r, strata)[lo:hi]

    def epoch_inputs(e: int, part: torch.Tensor) -> tuple:
        """``(pos, neg, priorities or None)`` of epoch ``e``: this rank's
        workers' batches and negatives, every worker's priorities."""
        if draws is not None:
            pos, neg, pri = _injected(draws(e), tcfg, dev)
            return pos[lo:hi], neg[lo:hi], pri
        pos = kg_lib.device_epoch_batches(keys_lib.fold_in(k_data, e),
                                          part, B, workers)
        wkeys = keys_lib.fold_in(keys_lib.fold_in(k_neg, e), workers)
        uniform, offset = negative.device_draws(wkeys, pos.shape[:-1], E,
                                                dev)
        neg = model.make_negatives(pos, tcfg, head_prob, uniform=uniform,
                                   offset=offset)
        return pos, neg, None

    def own_priorities(e_last: int) -> Optional[Dict[str, torch.Tensor]]:
        if cfg.strategy != "random":
            return None
        k = keys_lib.fold_in(k_merge, e_last)
        return {name: keys_lib.uniform(
                    keys_lib.fold_in(keys_lib.fold_in(k, i), all_workers),
                    rows[roles[name]], dev)
                for i, name in enumerate(sorted(roles))}

    def local_round(stacked: Params, eids: list, part: torch.Tensor,
                    losses: list) -> tuple:
        """K local epochs of all W workers from their copies ``stacked``:
        ``(stacked, summed stats with mean_loss / K, priorities)``."""
        acc = _zero_stats(tcfg, hi - lo, touch_losses, dev)
        for e in eids:
            pos, neg, priorities = epoch_inputs(e, part)
            stacked, stats = model.run_epoch(
                stacked, pos, neg, tcfg, sparse_apply=sparse,
                update_mask=update_mask, touch_losses=touch_losses,
                check_ids=False)
            acc = _add_stats(acc, stats)
            # over a mesh, the workers' losses are gathered at block end
            losses.append(stats.mean_loss if shard
                          else merge_lib.worker_mean(stats.mean_loss))
        acc = dataclasses.replace(acc, mean_loss=exact_div(acc.mean_loss, K))
        if priorities is None:
            priorities = own_priorities(eids[-1])
        return stacked, acc, priorities

    def clamp_frozen(merged: Params, base: Params) -> Params:
        """Frozen rows of a Reduce's output put back to the round input's
        (the merge arithmetic is not promised to be the identity on rows
        no worker moved); the input's frozen rows are the initial ones."""
        if update_mask is None:
            return merged
        return {name: torch.where(update_mask[name][:, None], merged[name],
                                  base[name])
                for name in merged}

    def sgd_block(params: Params, epoch_ids: list) -> tuple:
        part = block_part(epoch_ids)
        losses = []
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        for r0 in range(0, len(epoch_ids), K):
            stacked = _broadcast(params, hi - lo)
            # the round input: the sparse Reduce rebuilds untouched rows
            # from it; the dense one lets it go once copied
            base = params if sparse else None
            params = None
            stacked, acc, priorities = local_round(
                stacked, epoch_ids[r0:r0 + K], part, losses)
            if sparse and shard:
                params, o = _merge_tables_sparse_collective(
                    model, cfg, stacked, acc, priorities, base, tcfg,
                    n_steps, K, mesh)
            elif sparse:
                params, o = _merge_tables_sparse_stacked(
                    model, cfg, stacked, acc, priorities, base, tcfg,
                    n_steps, K)
            elif shard:
                params = _merge_tables_collective(model, cfg, stacked, acc,
                                                  priorities, mesh, lo)
            else:
                params = _merge_tables_stacked(model, cfg.strategy, stacked,
                                               acc, priorities)
            if sparse:
                overflow = torch.maximum(overflow, o)
                params = clamp_frozen(params, base)
                base = None
        if shard:
            return (params, _gathered_mean(torch.stack(losses, 1), mesh),
                    overflow)
        return params, torch.stack(losses), overflow

    def sgd_block_stale(state: tuple, epoch_ids: list) -> tuple:
        g, local = state
        state = None        # under donation the locals die with `local`
        part = block_part(epoch_ids)
        losses = []
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        for r0 in range(0, len(epoch_ids), K):
            eids = epoch_ids[r0:r0 + K]
            r = eids[0] // K
            gate = (offsets + r) % (S + 1) == 0
            if r == 0:
                gate = torch.ones_like(gate)
            adopt = gate[:, None, None]
            stacked = {name: torch.where(adopt, g[name], local[name])
                       for name in sorted(g)}
            local = None
            stacked, acc, priorities = local_round(stacked, eids, part,
                                                   losses)
            if shard:
                g, o = _merge_tables_stale_collective(
                    model, cfg, stacked, acc, priorities, g, n_steps, K,
                    mesh)
                overflow = torch.maximum(overflow, o)
            elif sparse:
                g, o = _merge_tables_stale_sparse(
                    model, cfg, stacked, acc, priorities, g, n_steps, K)
                overflow = torch.maximum(overflow, o)
            else:
                g = _merge_tables_stale_stacked(model, cfg.strategy, stacked,
                                                acc, priorities, g)
            local = stacked
        if shard:
            return ((g, local), _gathered_mean(torch.stack(losses, 1), mesh),
                    overflow)
        return (g, local), torch.stack(losses), overflow

    def bgd_block(params: Params, epoch_ids: list) -> tuple:
        part = block_part(epoch_ids)
        losses = []
        for e in epoch_ids:
            pos, neg, _ = epoch_inputs(e, part)
            if shard:
                params, loss = _bgd_epoch_collective(
                    model, cfg, tcfg, params, pos, neg, mesh,
                    check_ids=False)
            else:
                params, loss = bgd_epoch_vmap(params, pos, neg, cfg, tcfg,
                                              model, check_ids=False)
            losses.append(loss)
        # BGD's sparse buffers are sized exactly from the batch: no overflow
        return params, torch.stack(losses), torch.zeros(
            (), dtype=torch.int64, device=dev)

    if cfg.paradigm == "bgd":
        body = bgd_block
    else:
        body = sgd_block_stale if S > 0 else sgd_block

    def block_input(state):
        """The body's state: under donation the given dicts emptied into
        a copy; at rest over a mesh, the tables gathered whole."""
        if donate:
            state = _take_state(state)
        if layout is not None:
            state = _with_view(state, lambda g: sharding_lib.gather(
                g, layout, mesh))
        return state

    def block_fn(params, epoch_ids) -> tuple:
        epoch_ids = list(epoch_ids)
        if not epoch_ids or len(epoch_ids) % K:
            raise ValueError(
                f"a block runs whole merge rounds: {len(epoch_ids)} epochs "
                f"is not a positive multiple of merge_every={K}")
        # donated, the body's argument is the only reference to the
        # tables: this frame keeps none, so the body can drop them
        out = body(block_input(params), epoch_ids)
        if layout is not None:
            out = (_with_view(out[0], lambda g: sharding_lib.place(
                g, layout, W, mesh)),) + out[1:]
        return out if with_overflow else out[:2]

    return block_fn


def resting_layout(cfg: MapReduceConfig, tcfg: KGConfig,
                   model: KGModel) -> Optional[Dict[str, str]]:
    """How the device pipeline rests each table between blocks over a
    mesh (``parallel/sharding.kg_table_shardings``): ``None`` when every
    table stays whole (``table_sharding="replicated"``), else ``{name:
    "row" | "whole"}``, each dividing entity-role table kept as the row
    blocks of the rank's workers."""
    if cfg.table_sharding != "sharded":
        return None
    rows = {"ent": tcfg.n_entities, "rel": tcfg.n_relations}
    roles = model.param_roles()
    return sharding_lib.kg_table_shardings(
        roles, {name: rows[role] for name, role in roles.items()},
        cfg.n_workers, "sharded")


def _with_view(state, fn):
    """``fn`` applied to a block state's params: the params dict, or the
    global view of the stale ``(global_view, worker_locals)`` pair."""
    if isinstance(state, tuple):
        return (fn(state[0]), state[1])
    return fn(state)


def _take_state(state):
    """A block's state (a params dict, or the stale ``(global_view,
    worker_locals)`` pair of dicts) copied, the given dicts emptied."""
    if isinstance(state, tuple):
        return tuple(_take_state(d) for d in state)
    taken = dict(state)
    state.clear()
    return taken


def _raise_on_overflow(overflow, last_epoch: int) -> None:
    """The host's check at a Reduce boundary: a positive sparse-transport
    overflow means ``merge_lib.pack_delta`` dropped that many touched
    rows' updates this round, so the merged tables are corrupt; stop
    instead of training on.  Reads the device scalar (one host sync)."""
    n = int(overflow)
    if n > 0:
        raise RuntimeError(
            f"sparse-transport delta overflow at epoch {last_epoch}: a "
            f"Reduce round touched {n} more rows than the packed buffer "
            "capacity, so pack_delta dropped their updates and the merge "
            "is corrupt.  The analytic touched_capacity bound makes this "
            "impossible — an undersized MapReduceConfig.touched_capacity "
            "override (or a bound regression) is the cause; raise the "
            "override or pass None.")


@dataclasses.dataclass
class TrainResult:
    params: Params
    loss_history: list
    epochs_run: int
    model: str = "transe"
    # in-training evaluation (eval_loop / kg.fit(eval_every=...)): the
    # quality-vs-epoch trace, and — when keep_best — the params of the
    # best-metric boundary (paper-style model selection)
    trace: Optional[trace_lib.TrainingTrace] = None
    best_params: Optional[Params] = None
    best_epoch: Optional[int] = None
    # the persistent/serveable artifact view of this result — a
    # repro_torch.kb.KnowledgeBase assembled by kg.fit (None when train()
    # is driven directly below the facade)
    kb: Optional[object] = None


def _make_recorder(
    kg, tcfg: KGConfig, cfg: MapReduceConfig, model: KGModel,
    eval_loop: Optional[trace_lib.EvalLoopConfig],
) -> Optional[trace_lib.TraceRecorder]:
    if eval_loop is None:
        return None
    if cfg.pipeline == "device" and (
        eval_loop.eval_every % cfg.schedule.merge_every != 0
    ):
        raise ValueError(
            f"eval_every={eval_loop.eval_every} is not a multiple of "
            f"merge_every={cfg.schedule.merge_every} — in-loop evals run at "
            "Reduce boundaries (between Reduces the workers hold W "
            "divergent local copies, not a shared model); pick a multiple")
    return trace_lib.TraceRecorder(
        eval_loop, trace_lib.make_eval_fn(kg, model, tcfg.norm, eval_loop))


def _finish_result(params, history, epochs_run, model,
                   recorder) -> TrainResult:
    if recorder is None:
        return TrainResult(
            params=params, loss_history=history, epochs_run=epochs_run,
            model=model.name)
    return TrainResult(
        params=params, loss_history=history, epochs_run=epochs_run,
        model=model.name, trace=recorder.finalize(),
        best_params=recorder.best_params, best_epoch=recorder.best_epoch)


def _check_update_mask(update_mask, cfg: MapReduceConfig, tcfg: KGConfig,
                       model: KGModel, checkpoint, params) -> None:
    """``train()``'s refusals of an ``update_mask``, in the reference's
    order and words."""
    if cfg.paradigm != "sgd" or cfg.merge_transport != "sparse":
        raise ValueError(
            "update_mask requires paradigm='sgd' with "
            "merge_transport='sparse' — the masked fine-tune rides the "
            "sparse transport's touched-row machinery")
    if cfg.pipeline != "device":
        raise ValueError(
            "update_mask requires pipeline='device' — the host "
            "pipeline's per-epoch dispatch has no masked step")
    if cfg.staleness > 0:
        raise ValueError(
            f"update_mask with staleness={cfg.staleness}: stale worker "
            "locals would carry frozen-row drift across rounds; masked "
            "fine-tunes are synchronous")
    if checkpoint is not None:
        raise ValueError(
            "update_mask with checkpoint: masked fine-tunes persist "
            "through the online tier's delta checkpoints "
            "(repro_torch.online), not base kg_train snapshots")
    if params is None:
        raise ValueError(
            "update_mask without params: a masked fine-tune refines an "
            "existing artifact's tables — pass them")
    roles = model.param_roles()
    if set(update_mask) != set(roles):
        raise ValueError(
            f"update_mask tables {sorted(update_mask)} do not match "
            f"model {model.name!r} tables {sorted(roles)}")
    for name, m in update_mask.items():
        rows = (tcfg.n_entities if roles[name] == "ent"
                else tcfg.n_relations)
        if tuple(np.shape(m)) != (rows,):
            raise ValueError(
                f"update_mask[{name!r}] has shape {tuple(np.shape(m))}, "
                f"expected ({rows},) — one bool per row of the "
                f"{roles[name]!r}-role table")


def epoch_generator(seed: int, epoch: int, stream: int) -> torch.Generator:
    """A CPU generator seeded by (seed, epoch, stream): the port's draws of
    one epoch are a pure function of (seed, epoch)."""
    state = np.random.SeedSequence([seed, epoch, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _own_draws(model, cfg, tcfg, params, pos, head_prob, seed, epoch):
    """The port's own negatives and merge priorities for ``epoch``."""
    neg = model.make_negatives(
        pos, tcfg, head_prob,
        generator=epoch_generator(seed, epoch, _NEGATIVES))
    priorities = None
    if cfg.paradigm == "sgd" and cfg.strategy == "random":
        g = epoch_generator(seed, epoch, _PRIORITIES)
        priorities = {
            name: merge_lib.random_priorities(
                g, cfg.n_workers, params[name].shape[0], pos.device)
            for name in sorted(params)}
    return neg, priorities


def train(
    kg: kg_lib.KG,
    tcfg: KGConfig,
    cfg: MapReduceConfig,
    *,
    epochs: int = 50,
    seed: int = 0,
    params: Optional[Params] = None,
    callback: Optional[Callable[[int, float], None]] = None,
    model: Optional[KGModel] = None,
    device=None,
    draws: Optional[Callable[[int], "Draws | DeviceDraws"]] = None,
    eval_loop: Optional[trace_lib.EvalLoopConfig] = None,
    checkpoint: Optional[CheckpointConfig] = None,
    start_epoch: int = 0,
    resume_fresh_init: bool = True,
    prior_history: Optional[list] = None,
    stale_offsets=None,
    update_mask: Optional[Dict[str, object]] = None,
    mesh=None,
) -> TrainResult:
    """Training driver: balanced partitioning, deterministic batches,
    negative sampling, Map/Reduce epochs, loss history.  With
    ``cfg.pipeline == 'device'`` the epochs run in blocks
    (:func:`make_block_fn`); with ``'host'`` one epoch at a time.

    Balance rule: the partitioner gives every worker exactly
    ``N // n_workers`` triplets, and each epoch runs ``N_w // batch_size``
    steps per worker; a ``batch_size`` that does not divide ``N_w`` leaves
    the trailing ``N_w % batch_size`` triplets of each worker's per-epoch
    permutation out of that epoch, surfaced as a warning (a ``ValueError``
    under ``cfg.strict_batching``).

    ``params`` (default: the model's init from ``torch.Generator`` seed
    ``seed``) and all training tensors live on ``device`` (default: the
    GPU; raises without one unless ``device="cpu"``).  ``draws(epoch)``,
    when given, returns that epoch's negatives ``(W, S, B, 3)`` and, for
    the ``random`` strategy, each table's merge priorities ``(W, N)`` as
    numpy arrays, in place of the port's own draws; on the device
    pipeline it returns the epoch's batches ``(W, S, B, 3)`` first, and
    priorities at a merge round's last epoch.  Injected ids are checked
    against the tables on the host.  ``callback(epoch, loss)`` fires every
    epoch on the host pipeline, and at block boundaries (with the block's
    last epoch and its loss) on the device pipeline.

    In-training evaluation: ``eval_loop`` (a ``trace.EvalLoopConfig``, see
    ``kg.fit(eval_every=...)``) runs the evaluation protocol after every
    ``eval_every``-th epoch and after the last, records a
    ``TrainingTrace`` on the result, keeps the best-metric params and
    stops early on ``patience``.

    Checkpoint/resume: ``checkpoint`` (a :class:`CheckpointConfig`) saves
    params and manifest at epoch boundaries; ``start_epoch=N`` with the
    checkpointed ``params`` resumes a run bit-identically, since batches
    and draws are pure functions of (seed, absolute epoch) — ``draws``
    too is called with absolute epochs.  ``prior_history`` (the
    manifest's loss history) is prepended, so a resumed ``TrainResult``
    matches the unbroken run's.  ``resume_fresh_init`` (whether the
    original run drew its own init) changes nothing here; it is carried
    into later manifests, where the reference's resume needs it to replay
    its key chain.

    Bounded staleness (``cfg.staleness > 0``) cannot checkpoint or resume
    (it raises): the run's state holds every worker's local tables, which
    a Reduce-boundary checkpoint does not.  ``stale_offsets`` (``(W,)``
    ints in ``[0, staleness]``) replaces the run's own refresh phases, as
    ``draws`` replaces its draws (tests).

    Masked fine-tune: ``update_mask`` (one bool row mask per table, one
    bit per row of the table's role) freezes the rows whose bit is False
    bitwise while the free rows train as in an unmasked run of the same
    draws (:func:`make_block_fn`) — the online tier's incremental
    ``update()``.  It needs the SGD paradigm's device pipeline on the
    sparse transport, ``staleness=0``, the caller's ``params`` and no
    checkpoint (updates persist as delta checkpoints,
    ``repro_torch.online``).

    ``cfg.backend == "shard_map"``: every rank of ``mesh`` (a
    ``DeviceMesh`` with a ``"workers"`` dimension, of ``device``'s
    type; ``parallel/util.py``) calls ``train`` with the same arguments
    and runs its block of the W workers; the Reduces are collectives, and
    every rank returns the same result (the vmap backend's bits, but for
    the psum Reduce and dense BGD at M > 1, within rtol 1e-4 / atol
    1e-5).  Only the mesh's rank 0 writes checkpoints, and the ranks meet
    at a barrier once it has finished, before ``train`` returns.

    ``cfg.n_workers == 1`` reproduces single-thread Algorithm 1 (the
    paper's baseline) for the chosen model."""
    model = _resolve(cfg, model)
    device = resolve_device(device)
    shard = cfg.backend == "shard_map"
    if shard:
        _check_mesh(cfg, mesh, device)
    if update_mask is not None:
        _check_update_mask(update_mask, cfg, tcfg, model, checkpoint, params)
    if start_epoch < 0 or (start_epoch and start_epoch >= epochs):
        raise ValueError(
            f"start_epoch={start_epoch} must be in [0, epochs={epochs}) — "
            "resuming a checkpoint at or past the requested epoch count "
            "has nothing left to train; raise epochs")
    if cfg.pipeline == "device" and start_epoch % cfg.schedule.merge_every:
        raise ValueError(
            f"start_epoch={start_epoch} is not a multiple of "
            f"merge_every={cfg.schedule.merge_every} — device-pipeline "
            "checkpoints live at Reduce boundaries")
    if (checkpoint is not None and checkpoint.every is not None
            and cfg.pipeline == "device"
            and checkpoint.every % cfg.schedule.merge_every):
        raise ValueError(
            f"checkpoint every={checkpoint.every} is not a multiple of "
            f"merge_every={cfg.schedule.merge_every} — checkpoints are "
            "shared-model states, which only exist at Reduce boundaries")
    if cfg.staleness > 0 and (checkpoint is not None or start_epoch > 0):
        raise ValueError(
            f"staleness={cfg.staleness} cannot checkpoint or resume — the "
            "run state includes every worker's stale local tables, which "
            "the Reduce-boundary manifest does not capture; bounded-"
            "staleness runs reproduce by full rerun instead (all their "
            "randomness is a fold_in-pure function of (seed, round, "
            "worker))")
    if stale_offsets is not None:
        offs = np.asarray(stale_offsets)
        if cfg.staleness == 0 or offs.shape != (cfg.n_workers,) or (
                offs.min() < 0 or offs.max() > cfg.staleness):
            raise ValueError(
                f"stale_offsets must be {cfg.n_workers} ints in "
                f"[0, staleness] of a staleness > 0 run; got {offs!r} "
                f"with staleness={cfg.staleness}")
    partitioned = kg_lib.PARTITIONERS[cfg.partition](
        seed, kg.train, cfg.n_workers)
    _check_ids(partitioned, tcfg, "the training split")
    # strata for the degree partitioner's re-partition rounds: labels over
    # the flattened (partition-order) triplets; each round permutes the
    # original partition, so the labels stay valid every round
    strata = None
    if (cfg.partition == "degree" and cfg.pipeline == "device"
            and cfg.schedule.repartition_every is not None):
        strata = kg_lib.triplet_strata(partitioned.reshape(-1, 3),
                                       tcfg.n_entities)
    n_w = partitioned.shape[1]
    if n_w < cfg.batch_size:
        raise ValueError(
            f"batch_size={cfg.batch_size} exceeds the {n_w} triplets each "
            f"of the {cfg.n_workers} workers holds — zero steps per epoch; "
            "shrink batch_size or n_workers")
    remainder = n_w % cfg.batch_size
    if remainder:
        msg = (
            f"batch_size={cfg.batch_size} does not divide the per-worker "
            f"split of {n_w} triplets — each epoch leaves out the trailing "
            f"{remainder} triplets of every worker's permutation "
            f"({remainder * cfg.n_workers} of {n_w * cfg.n_workers} total); "
            "the per-epoch reshuffle rotates which triplets sit out, so all "
            "of them still train over time.  Pick a batch_size dividing "
            f"{n_w} to use every triplet every epoch.")
        if cfg.strict_batching:
            raise ValueError(msg)
        warn_fresh(msg, stacklevel=2)
    _check_touched_capacity(cfg, tcfg, model, n_w // cfg.batch_size)

    head_prob = None
    if tcfg.sampling == "bern":
        head_prob = torch.as_tensor(
            negative.bernoulli_stats(kg.train, kg.n_relations), device=device)
    caller_params = params is not None
    if params is None:
        params = model.init_params(
            torch.Generator().manual_seed(seed), tcfg, device=device)
    elif set(params) != set(model.param_roles()):
        raise ValueError(
            f"params have tables {sorted(params)} but model "
            f"{model.name!r} expects {sorted(model.param_roles())} — "
            "params from a different model?")
    else:
        params = {name: (p if isinstance(p, torch.Tensor)
                         else torch.tensor(np.asarray(p))).to(
                             device=device, dtype=tcfg.dtype)
                  for name, p in params.items()}
        rows = {"ent": tcfg.n_entities, "rel": tcfg.n_relations}
        for name, role in model.param_roles().items():
            if params[name].shape[0] != rows[role]:
                raise ValueError(
                    f"params[{name!r}] has {params[name].shape[0]} rows; "
                    f"the graph has {rows[role]} {role} ids")

    recorder = _make_recorder(kg, tcfg, cfg, model, eval_loop)
    writer = None
    # over a mesh only rank 0 writes: M ranks renaming the same step
    # directory into place would race
    if checkpoint is not None and not (shard and par.mesh_rank(mesh)):
        writer = _CheckpointWriter(checkpoint, {
            "kind": "kg_train",
            "model": model.name,
            "seed": seed,
            "paradigm": cfg.paradigm,
            "pipeline": cfg.pipeline,
            "dim": tcfg.dim,
            "n_entities": tcfg.n_entities,
            "n_relations": tcfg.n_relations,
            # whether the ORIGINAL epoch-0 run drew its own init: what the
            # reference's resume replays its key chain by
            "fresh_init": (not caller_params if start_epoch == 0
                           else resume_fresh_init),
            "graph": kg.fingerprint(),
            "config": resume_config(tcfg, cfg),
        })

    if cfg.pipeline == "device":
        return _train_device(
            tcfg, cfg, model, partitioned, head_prob, params,
            epochs=epochs, seed=seed, device=device, callback=callback,
            recorder=recorder, eval_loop=eval_loop, writer=writer,
            start_epoch=start_epoch, prior_history=prior_history,
            strata=strata, draws=draws, stale_offsets=stale_offsets,
            update_mask=update_mask, mesh=mesh, checkpoint=checkpoint)

    # the ids are proved in range: the partition above, the own negatives
    # by construction, injected ones as they come in; a sparse SGD run's
    # overflow is read at every Reduce (the loop reads the loss anyway)
    with_overflow = cfg.paradigm == "sgd" and cfg.merge_transport == "sparse"
    epoch_fn = make_epoch_fn(cfg, tcfg, model, check_ids=False,
                             with_overflow=with_overflow, mesh=mesh)
    history = list(prior_history or [])
    epochs_run = epochs
    for epoch in range(start_epoch, epochs):
        pos = torch.as_tensor(
            kg_lib.epoch_batches(seed, epoch, partitioned, cfg.batch_size),
            device=device)
        if draws is None:
            neg, priorities = _own_draws(model, cfg, tcfg, params, pos,
                                         head_prob, seed, epoch)
        else:
            neg, priorities = _injected(draws(epoch), tcfg, device)
        if with_overflow:
            params, loss, overflow = epoch_fn(params, pos, neg, priorities)
            _raise_on_overflow(overflow, epoch)
        else:
            params, loss = epoch_fn(params, pos, neg, priorities)
        loss = float(loss)
        history.append(loss)
        if callback is not None:
            callback(epoch, loss)
        # every epoch ends in a Reduce, so any eval_every lands on a
        # Reduce boundary; the final epoch is always evaluated
        done = epoch + 1
        stop = False
        if recorder is not None and (
            done % eval_loop.eval_every == 0 or done == epochs
        ):
            stop = recorder.record(epoch, done, loss, params)
        if writer is not None and writer.due(done, epochs, stopping=stop):
            writer.save(done, params, history)
        if stop:
            epochs_run = done
            break
    _finish_writes(writer, cfg, mesh)
    return _finish_result(params, history, epochs_run, model, recorder)


def _finish_writes(writer: Optional[_CheckpointWriter], cfg: MapReduceConfig,
                   mesh) -> None:
    """Wait for the run's checkpoint writes; over a mesh the ranks then
    meet, so no rank reads a step rank 0 is still writing."""
    if writer is not None:
        writer.finish()
    if cfg.backend == "shard_map":
        par.barrier(mesh)


def _train_device(
    tcfg: KGConfig,
    cfg: MapReduceConfig,
    model: KGModel,
    partitioned: np.ndarray,     # (W, N_w, 3) host array from the partitioner
    head_prob: Optional[torch.Tensor],
    params: Params,
    *,
    epochs: int,
    seed: int,
    device,
    callback: Optional[Callable[[int, float], None]],
    recorder: Optional[trace_lib.TraceRecorder],
    eval_loop: Optional[trace_lib.EvalLoopConfig],
    writer: Optional[_CheckpointWriter],
    start_epoch: int,
    prior_history: Optional[list],
    strata: Optional[np.ndarray],
    draws: Optional[Callable[[int], DeviceDraws]],
    stale_offsets=None,
    update_mask: Optional[Dict[str, object]] = None,
    mesh=None,
    checkpoint: Optional[CheckpointConfig] = None,
) -> TrainResult:
    """Device-pipeline driver: put the partition (and the degree strata)
    on the device once, then run epochs in blocks (:func:`make_block_fn`).
    Blocks are sliced at evaluation, checkpoint and re-partition
    boundaries — each a multiple of ``merge_every``, so every block ends
    on a Reduce, and block invariance keeps the sliced run bit-identical
    to the unsliced one.  The host reads a block's losses only where it
    needs them: the callback and an evaluation read the last one, a
    checkpoint and the result the history.  A resume starts the epoch ids
    at ``start_epoch``; every draw is a pure function of (seed, epoch), so
    nothing is replayed.  Under bounded staleness the blocks thread
    ``(global_view, worker_locals)``, the locals starting as W copies of
    the initial tables (round 0 refreshes every worker anyway) and
    surviving every block boundary; evaluation, the callback and the
    result read the global view.  Over a mesh (``shard_map``) each rank
    puts only its workers' ``(W/M, N_w, 3)`` partitions on its device and
    keeps only its workers' stale locals; under sharded tables it rests
    only its workers' row blocks of each dividing entity-role table
    between blocks (:func:`resting_layout`), and every rank all-gathers
    whole tables where an evaluation, a checkpoint or the result needs
    them.  Every rank slices its blocks at the ``checkpoint``'s cadence,
    whichever rank writes it, so all ranks run the same blocks and meet
    in the same collectives."""
    sched = cfg.schedule
    if epochs % sched.merge_every != 0:
        raise ValueError(
            f"epochs={epochs} is not a multiple of "
            f"merge_every={sched.merge_every} — the trailing local epochs "
            "would never be Reduced into the shared params; pick a multiple")
    with_overflow = cfg.paradigm == "sgd" and cfg.merge_transport == "sparse"
    shard = cfg.backend == "shard_map"
    lo, hi = 0, cfg.n_workers
    layout = None
    if shard:
        lo, hi = par.local_workers(mesh, cfg.n_workers)
        partitioned = partitioned[lo:hi]
        layout = resting_layout(cfg, tcfg, model)
    block_fn = make_block_fn(
        cfg, tcfg, torch.as_tensor(partitioned, device=device), model=model,
        head_prob=head_prob, seed=seed,
        donate=cfg.donate_params is not False,
        strata=None if strata is None else torch.as_tensor(strata,
                                                           device=device),
        draws=draws, with_overflow=with_overflow,
        stale_offsets=stale_offsets, update_mask=update_mask, mesh=mesh)
    stale = cfg.staleness > 0
    # over a mesh each rank keeps its own workers' locals, and under
    # sharded tables only its workers' row blocks of the global view
    state = (params, _broadcast(params, hi - lo)) if stale else params
    if layout is not None:
        state = _with_view(state, lambda g: sharding_lib.place(
            g, layout, cfg.n_workers, mesh))
    params = None

    def whole(state) -> Params:
        """The params (the stale global view) as whole tables: over a
        mesh under sharded tables, a collective every rank calls."""
        g = state[0] if stale else state
        return g if layout is None else sharding_lib.gather(g, layout, mesh)

    # every rank gathers where any rank needs whole tables (only rank 0
    # holds the checkpoint writer)
    need_whole = recorder is not None or checkpoint is not None

    eval_every = eval_loop.eval_every if eval_loop is not None else None
    ckpt_every = checkpoint.every if checkpoint is not None else None
    repart = sched.repartition_every
    loss_blocks = []
    history = list(prior_history or [])    # host floats read so far

    def snapshot_history() -> list:
        while loss_blocks:
            history.extend(loss_blocks.pop(0).tolist())
        return history

    start = start_epoch
    epochs_run = epochs
    while start < epochs:
        length = min(sched.block_epochs, epochs - start)
        for every in (eval_every, ckpt_every, repart):
            if every is not None:
                length = min(length, every - start % every)
        if with_overflow:           # read once a block, never inside one
            state, losses, overflow = block_fn(state,
                                               range(start, start + length))
            _raise_on_overflow(overflow, start + length - 1)
        else:
            state, losses = block_fn(state, range(start, start + length))
        params = whole(state) if need_whole else None
        loss_blocks.append(losses)
        start += length
        last = None
        if callback is not None:
            last = float(losses[-1])
            callback(start - 1, last)
        stop = False
        if recorder is not None and (
            start % eval_every == 0 or start == epochs
        ):
            stop = recorder.record(
                start - 1, start // sched.merge_every,
                float(losses[-1]) if last is None else last, params)
        if writer is not None and writer.due(start, epochs, stopping=stop):
            writer.save(start, params, snapshot_history())
        if stop:
            epochs_run = start
            break
    _finish_writes(writer, cfg, mesh)
    return _finish_result(whole(state), snapshot_history(), epochs_run,
                          model, recorder)
