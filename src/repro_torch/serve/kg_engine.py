"""Device-resident KG link-prediction query engine (port of
``repro.serve.kg_engine``; whole tables on one device — sharded tables are
not ported yet).

A batch of queries is padded and cut into chunks exactly like the eval
engine's test split (``core/eval_device._layout``).  Every chunk scores
all E entities through the model's ``candidate_energies``, masks excluded
candidates to +inf (pad id = E never lands; serve-time exclusion = the
KG's ``known_candidate_masks``), and keeps the ``k`` best on the device;
only the final ``(B, k)`` arrays return to the host.  ``query_relations``
is the same walk over ``relation_energies``.

Ties in energy go to the lowest id, as ``jax.lax.top_k`` breaks them in
the reference: ``torch.topk`` promises no order among ties, so the engine
sorts each row stably and keeps the first ``k``.

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
from repro_torch.core.models import KGModel, Params, get_model

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


class KGQueryEngine:
    """Batched link prediction over one (model, params) pair.

    Any batch size works; the layout pads to ``chunk`` granularity the way
    the eval engine does.  ``exclude`` masks are padded ``(B, P)`` id
    arrays (pad id = n_entities), the layout ``KG.known_candidate_masks``
    builds — ``KnowledgeBase`` passes known neighbors so served
    candidates are *new* links."""

    def __init__(
        self,
        model: "str | KGModel",
        params: Params,
        *,
        norm: str = "l1",
        chunk: int = DEFAULT_CHUNK,
    ):
        self.model = get_model(model)
        self.params = params
        self.norm = norm
        self.chunk = chunk
        self.n_entities = int(params["ent"].shape[0])
        self.n_relations = int(params["rel"].shape[0])
        self.device = params["ent"].device

    def _chunk_queries(self, triplets: np.ndarray, exclude,
                       chunk: Optional[int] = None):
        """``(S, C, 3)`` queries and ``(S, C, P)`` exclusions on the device,
        plus the unpadded count."""
        Q = len(triplets)
        S, C, Qp = eval_device._layout(
            Q, self.chunk if chunk is None else chunk)
        q = eval_device._chunks(
            eval_device._pad_rows(np.asarray(triplets, np.int32), Qp),
            S, C, self.device)
        if exclude is None:
            exclude = np.full((Q, 1), self.n_entities, np.int32)
        ex = eval_device._chunks(
            eval_device._pad_rows(np.asarray(exclude, np.int32), Qp),
            S, C, self.device)
        return q, ex, Q

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

    @staticmethod
    def _result(ids: list, energies: list, Q: int) -> QueryResult:
        return QueryResult(torch.cat(ids).cpu().numpy()[:Q],
                           _host_energies(torch.cat(energies))[:Q])

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

    def _entity_topk(self, triplets, side, k, exclude,
                     chunk: Optional[int] = None) -> QueryResult:
        k = min(_check_k(k), self.n_entities)
        E = self.n_entities
        q, ex, Q = self._chunk_queries(triplets, exclude, chunk)
        ids, energies = [], []
        with torch.no_grad():
            for s in range(q.shape[0]):
                scores = self.model.candidate_energies(
                    self.params, q[s], side, self.norm)
                rows, cols = torch.nonzero(ex[s] < E, as_tuple=True)
                scores[rows, ex[s][rows, cols]] = torch.inf
                i, e = _topk_lowest(scores, k)
                ids.append(i)
                energies.append(e)
        out = self._result(ids, energies, Q)
        _note_shape("entity", self.model, side, self.norm, k, q, ex,
                    self.params)
        return out

    def query_relations(self, heads, tails, k: int = 10,
                        chunk: Optional[int] = None) -> QueryResult:
        """Top-k relations linking ``(h, ?, t)`` pairs."""
        k = min(_check_k(k), self.n_relations)
        triplets = self._pair_triplets(heads, tails, "relation")
        q, _, Q = self._chunk_queries(triplets, None, chunk)
        ids, energies = [], []
        with torch.no_grad():
            for s in range(q.shape[0]):
                scores = self.model.relation_energies(
                    self.params, q[s], self.norm)
                i, e = _topk_lowest(scores, k)
                ids.append(i)
                energies.append(e)
        out = self._result(ids, energies, Q)
        _note_shape("relation", self.model, "relation", self.norm, k, q,
                    None, self.params)
        return out

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
            model=self.model, chunk=self.chunk, fused=fused)
        group = "filtered_ranks" if cand_masks is not None else "raw_ranks"
        return out[group][side]
