"""Device-resident KG link-prediction query engine (port of
``repro.serve.kg_engine``, vmap backend, replicated or sharded tables).

A batch of queries is padded and cut into chunks exactly like the eval
engine's test split (``core/eval_device.shard_chunks``).  Every chunk scores
all E entities through the model's ``candidate_energies``, masks excluded
candidates to +inf (pad id = E never lands; serve-time exclusion = the
KG's ``known_candidate_masks``), and keeps the ``k`` best on the device;
only the final ``(B, k)`` arrays return to the host.  ``query_relations``
is the same walk over ``relation_energies``.

Ties in energy go to the lowest id, as ``jax.lax.top_k`` breaks them in
the reference: ``torch.topk`` promises no order among ties, so the engine
sorts each row stably and keeps the first ``k``.

``table_sharding="sharded"`` cuts the entity axis into ``n_workers``
shards (``_entity_topk_sharded``): each shard scores its block of rows,
keeps its own best ``min(k, R)``, and the shard-major union of those
lists is cut to ``k``, with the same stable sort.  Every answer the whole
table's top-k holds survives its shard's cut, and the union lists tied
candidates in ascending id, so ids *and* energies are the replicated
engine's, bitwise, ties included.

Both backends walk the chunks through one path (``parallel/util.
worker_map``, as the eval engine does): on ``backend="shard_map"`` with
``mesh=`` (every rank of the mesh calls the query collectively) the
queries split over the W workers and the workers over the ranks, and the
ranks' answers are all-gathered in rank order; on ``vmap`` the query axis
is one worker (``eval_device.query_workers``).  Every rank returns the
vmap engine's ids and energies exactly.  Sharded tables over a mesh are
ROADMAP.md item 12d.

``rank()`` routes ad-hoc triplet batches through the *eval* engine
(``core/eval_device.entity_ranks_device``), including its rank-kernel
dispatch on CUDA tables, so a served candidate's rank is what
``kg.evaluate`` reports for the same query.

Eager PyTorch compiles nothing, so the reference's recompile gate (its
jit cache) has no counterpart here. What the first call at a new shape
pays on the card instead is allocator growth, sort workspaces and lazy
module loads. The engine therefore keeps a module-level registry of every
distinct computation it has run, keyed on what the reference's jit keys
on (entry, model, side, norm, ``k``, the ``(S, C)`` layout, the exclusion
width ``P``, each table's shape and dtype, and the device);
:func:`shapes_seen` is its size, the counter behind the serving tier's
``steady_recompiles`` (``serve/server.py``).

Energies are "lower = truer" throughout; excluded candidates surface as
+inf energies when ``k`` exceeds the live candidate count.  Energies of
bf16 tables come back widened to float32 (exactly: numpy has no bf16
type).  A negative ``k`` raises ``ValueError``, as ``jax.lax.top_k`` does
in the reference; ``k = 0`` gives an empty ``(B, 0)`` answer.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import eval_device
from repro_torch.core import merge as merge_lib
from repro_torch.core.models import KGModel, Params, get_model
from repro_torch.parallel import util as par

DEFAULT_CHUNK = eval_device.DEFAULT_CHUNK

_SHAPES: set = set()            # every distinct computation run (above)
_SHAPES_LOCK = threading.Lock()


def shapes_seen() -> int:
    """How many distinct computations the engine has run in this process:
    the size of the shape registry (module docstring)."""
    with _SHAPES_LOCK:
        return len(_SHAPES)


def _note_shape(entry: str, model: KGModel, side: str, norm: str, k: int,
                q: torch.Tensor, ex: Optional[torch.Tensor],
                params: Params) -> None:
    S, C = q.shape[:2]
    P = None if ex is None else int(ex.shape[2])
    tables = tuple((name, tuple(t.shape), str(t.dtype))
                   for name, t in sorted(params.items()))
    key = (entry, model.name, side, norm, k, S, C, P, tables,
           str(q.device))
    with _SHAPES_LOCK:
        _SHAPES.add(key)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One batched top-k answer: ``ids[i, j]`` is the j-th best candidate
    for query ``i`` and ``energies[i, j]`` its model energy (ascending per
    row — best first; +inf marks excluded slots)."""

    ids: np.ndarray        # (B, k) int32
    energies: np.ndarray   # (B, k) float32


def _host_energies(e: torch.Tensor) -> np.ndarray:
    """Energies as a host float32 array.  bf16 energies widen to float32,
    which holds every bf16 value exactly: numpy has no bf16 type."""
    if e.dtype == torch.bfloat16:
        e = e.float()
    return e.cpu().numpy()


def _check_k(k) -> int:
    k = int(k)
    if k < 0:
        raise ValueError(f"k argument to top_k must be nonnegative, got {k}")
    return k


def _topk_lowest(scores: torch.Tensor, k: int):
    """The ``k`` smallest scores per row, ties toward the lowest column."""
    vals, ids = torch.sort(scores, dim=1, stable=True)
    return ids[:, :k].int(), vals[:, :k]


def _entity_topk_sharded(
    model: KGModel,
    params: Params,          # entity-role tables padded to n_shards * R
    q: torch.Tensor,         # (C, 3)
    ex: torch.Tensor,        # (C, P) padded exclusion ids (pad id = E)
    side: str,
    norm: str,
    k: int,
    n_shards: int,
    n_entities: int,
) -> tuple:
    """One chunk's top-k with the candidate axis sharded (the reference's
    ``_entity_topk_sharded``, vmap form): per shard, its ``(C, R)`` slice
    (``candidate_slice_energies``), pad rows and the excluded ids it owns
    set to +inf, and its ``min(k, R)`` best (:func:`_topk_lowest`); then
    the shard-major union ``(C, W·kk)`` cut to ``k`` by the same stable
    sort.  Within a tie the union lists ids in ascending order (shards
    hold ascending id ranges, and each local list is id-ascending within
    ties), so the answer is the replicated scan's, ids and energies."""
    E, W = n_entities, n_shards
    R = merge_lib.shard_rows(E, W)
    kk = min(k, R)
    cols = torch.arange(R, device=q.device)
    ids, energies = [], []
    for s in range(W):
        lo = s * R
        sc = model.candidate_slice_energies(params, q, side, norm, lo=lo,
                                            n=R)
        sc = torch.where((lo + cols >= E)[None, :], torch.inf, sc)
        off = ex - lo
        valid = (off >= 0) & (off < R) & (ex < E)
        # ids outside the block write -inf, which max() ignores
        sc = sc.scatter_reduce(
            1, off.clamp(0, R - 1),
            torch.where(valid, torch.inf, -torch.inf).to(sc.dtype), "amax")
        i, e = _topk_lowest(sc, kk)
        ids.append(i + lo)
        energies.append(e)
    j, e = _topk_lowest(torch.cat(energies, 1), k)
    return torch.cat(ids, 1).gather(1, j.long()), e


class KGQueryEngine:
    """Batched link prediction over one (model, params) pair.

    Any batch size works; the layout pads to ``chunk`` granularity the way
    the eval engine does.  ``exclude`` masks are padded ``(B, P)`` id
    arrays (pad id = n_entities), the layout ``KG.known_candidate_masks``
    builds — ``KnowledgeBase`` passes known neighbors so served
    candidates are *new* links.

    ``table_sharding="sharded"`` scans the entity axis in ``n_workers``
    shards (module docstring); ``rank()`` threads the layout into the
    eval scan, and ``score()`` and relation queries never shard (the
    relation table is whole on every shard).  ``backend="shard_map"``
    with ``mesh`` splits the queries over the mesh's ranks, every rank
    calling each query collectively (module docstring)."""

    def __init__(
        self,
        model: "str | KGModel",
        params: Params,
        *,
        norm: str = "l1",
        n_workers: int = 1,
        backend: str = "vmap",
        mesh=None,
        chunk: int = DEFAULT_CHUNK,
        table_sharding: str = "replicated",
    ):
        eval_device.check_layout(table_sharding, n_workers, backend, mesh,
                                 params["ent"].device)
        self.model = get_model(model)
        self.params = params
        self.norm = norm
        self.n_workers = n_workers
        self.backend = backend
        self.mesh = mesh
        self.chunk = chunk
        self.table_sharding = table_sharding
        self.n_entities = int(params["ent"].shape[0])
        self.n_relations = int(params["rel"].shape[0])
        self.device = params["ent"].device
        self._padded_params = None
        if table_sharding == "sharded":
            # padded once here; rank() and score() keep the tables as given
            self._padded_params = eval_device._pad_ent_tables(
                self.model, params,
                n_workers * merge_lib.shard_rows(self.n_entities, n_workers))

    @staticmethod
    def _pair_triplets(a, b, side: str) -> np.ndarray:
        a = np.atleast_1d(np.asarray(a, np.int32))
        b = np.atleast_1d(np.asarray(b, np.int32))
        a, b = np.broadcast_arrays(a, b)
        zero = np.zeros_like(a)
        if side == "tail":              # (h, r, ?) — gold slot unused
            cols = (a, b, zero)
        elif side == "head":            # (?, r, t)
            cols = (zero, b, a)
        else:                           # (h, ?, t) for relation queries
            cols = (a, zero, b)
        return np.stack(cols, axis=1)

    # -- queries -----------------------------------------------------------

    def query_tails(self, heads, rels, k: int = 10,
                    exclude: Optional[np.ndarray] = None,
                    chunk: Optional[int] = None) -> QueryResult:
        """Top-k tail completions of ``(h, r, ?)`` for a batch of (heads,
        rels) id arrays.  ``exclude`` drops known candidates; ``chunk``
        overrides the engine's chunk for this call."""
        return self._entity_topk(
            self._pair_triplets(heads, rels, "tail"), "tail", k, exclude,
            chunk)

    def query_heads(self, tails, rels, k: int = 10,
                    exclude: Optional[np.ndarray] = None,
                    chunk: Optional[int] = None) -> QueryResult:
        """Top-k head completions of ``(?, r, t)``."""
        return self._entity_topk(
            self._pair_triplets(tails, rels, "head"), "head", k, exclude,
            chunk)

    def _walk(self, per_chunk, triplets, exclude, chunk, entry: str,
              side: str, k: int) -> QueryResult:
        """One query batch: ``per_chunk(q, ex)`` answers one ``(C, 3)``
        chunk with ``(ids, energies)`` of ``(C, k)``; each worker walks
        its ``S`` chunks, and on ``shard_map`` the grids come back
        all-gathered from every rank (module docstring)."""
        Q = len(triplets)
        C = self.chunk if chunk is None else chunk
        W = eval_device.query_workers(self.n_workers, self.backend)
        grid = lambda a: eval_device.shard_chunks(
            np.asarray(a, np.int32), W, C, Q)
        if exclude is None:
            exclude = np.full((Q, 1), self.n_entities, np.int32)

        def worker(_, q_w, ex_w):
            q_w, ex_w = (torch.as_tensor(x, device=self.device)
                         for x in (q_w, ex_w))
            with torch.no_grad():
                outs = [per_chunk(q_w[s], ex_w[s])
                        for s in range(q_w.shape[0])]
            _note_shape(entry, self.model, side, self.norm, k, q_w,
                        None if entry.startswith("relation") else ex_w,
                        self.params)
            # energies widened before any gather (bf16 widens exactly)
            return (torch.stack([i for i, _ in outs]),
                    torch.stack([e.float() if e.dtype == torch.bfloat16
                                 else e for _, e in outs]))

        ids, energies = par.worker_map(
            worker, backend=self.backend, mesh=self.mesh)(
                None, grid(triplets), grid(exclude))
        # (W, S, C, k) grids -> (W·S·C, k) rows, cut to the batch
        return QueryResult(ids.flatten(0, 2).cpu().numpy()[:Q],
                           energies.flatten(0, 2).cpu().numpy()[:Q])

    def _entity_scores_topk(self, q: torch.Tensor, ex: torch.Tensor,
                            side: str, k: int) -> tuple:
        """One chunk's top-k over the whole table, exclusions at +inf."""
        scores = self.model.candidate_energies(self.params, q, side,
                                               self.norm)
        rows, cols = torch.nonzero(ex < self.n_entities, as_tuple=True)
        scores[rows, ex[rows, cols]] = torch.inf
        return _topk_lowest(scores, k)

    def _entity_topk(self, triplets, side, k, exclude,
                     chunk: Optional[int] = None) -> QueryResult:
        k = min(_check_k(k), self.n_entities)
        if self.table_sharding == "sharded":
            per_chunk = lambda q, ex: _entity_topk_sharded(
                self.model, self._padded_params, q, ex, side, self.norm, k,
                self.n_workers, self.n_entities)
            entry = f"entity-sharded{self.n_workers}"
        else:
            per_chunk = lambda q, ex: self._entity_scores_topk(q, ex, side,
                                                               k)
            entry = ("entity-shard_map" if self.backend == "shard_map"
                     else "entity")
        return self._walk(per_chunk, triplets, exclude, chunk, entry, side,
                          k)

    def query_relations(self, heads, tails, k: int = 10,
                        chunk: Optional[int] = None) -> QueryResult:
        """Top-k relations linking ``(h, ?, t)`` pairs."""
        k = min(_check_k(k), self.n_relations)
        entry = ("relation-shard_map" if self.backend == "shard_map"
                 else "relation")
        return self._walk(
            lambda q, _: _topk_lowest(self.model.relation_energies(
                self.params, q, self.norm), k),
            self._pair_triplets(heads, tails, "relation"), None, chunk,
            entry, "relation", k)

    def score(self, heads, rels, tails) -> np.ndarray:
        """Model energies of fully-specified ``(h, r, t)`` triplets
        (lower = more plausible)."""
        h = np.atleast_1d(np.asarray(heads, np.int64))
        r = np.atleast_1d(np.asarray(rels, np.int64))
        t = np.atleast_1d(np.asarray(tails, np.int64))
        h, r, t = np.broadcast_arrays(h, r, t)
        triplets = torch.as_tensor(np.stack([h, r, t], axis=1),
                                   device=self.device)
        with torch.no_grad():
            return _host_energies(
                self.model.energy(self.params, triplets, self.norm))

    def rank(
        self,
        triplets: np.ndarray,
        side: str = "tail",
        cand_masks=None,
        fused: Optional[bool] = None,
    ) -> np.ndarray:
        """Rank the gold entity of each ``(h, r, t)`` among all entities —
        the *eval* engine's walk (including its rank kernel on CUDA
        tables), so a served candidate's rank is what ``kg.evaluate``
        reports.  ``cand_masks`` applies the filtered-ranking correction (a
        padded id array as in ``KG.eval_filter_candidates``, one-sided)."""
        # the eval walk computes both sides; feed the one-sided mask to
        # both and read back only the requested side
        masks = None if cand_masks is None else (cand_masks, cand_masks)
        out = eval_device.entity_ranks_device(
            self.params, np.asarray(triplets, np.int32), self.norm, masks,
            model=self.model, chunk=self.chunk, n_workers=self.n_workers,
            backend=self.backend, mesh=self.mesh, fused=fused,
            table_sharding=self.table_sharding)
        group = "filtered_ranks" if cand_masks is not None else "raw_ranks"
        return out[group][side]
