"""Knowledge-graph data: the host half of ``repro.data.kg``.

A ``KG`` holds a train/valid/test split of ``(h, r, t)`` id triplets as
numpy arrays, with the lazily built known-triplet structures both
evaluation engines filter with.  ``synthetic_kg`` generates a graph whose
triplets satisfy the TransE assumption ``z_h + g_r ≈ z_t`` by
construction; ``load_tsv_dir`` reads the FB15k / WN18 release layout.
The partitioners split the training triplets into the paper's balanced
worker subsets, and ``epoch_batches`` cuts each epoch's minibatches.

Everything here is numpy and byte-for-byte the reference's arithmetic, so
the same arguments give the same arrays in both packages (the reference
module imports jax, which is why the port keeps its own copy).  The one
random draw that differs is ``KG.tc_negatives``: the reference draws with
``jax.random``, the port with a seeded ``torch.Generator``.  ``KG.extend``
returns a grown copy (the online tier's graph update).

The device pipeline's batching (``device_*``, ``repartition_perm*``) is
torch on the run's device: the same functions as the reference's, drawn
from the port's counter-based keys (``core/keys.py``) in place of
``jax.random``, so they differ from the reference's draws but keep its
contract — a pure function of (key, round) or (key, epoch, worker), the
same bits on the CPU and the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import keys as keys_lib
from repro_torch.util import warn_fresh


@dataclasses.dataclass
class KG:
    """A knowledge graph with a train/valid/test triplet split."""

    n_entities: int
    n_relations: int
    train: np.ndarray           # (N_tr, 3) int32 rows of (h, r, t)
    valid: np.ndarray
    test: np.ndarray

    # lazily built known-triplet structures; not part of the dataclass
    # comparison/repr surface
    _known: Optional[set] = dataclasses.field(
        default=None, repr=False, compare=False)
    _known_index: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    _filter_cands: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _tc_negatives: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def all_triplets(self) -> np.ndarray:
        return np.concatenate([self.train, self.valid, self.test], axis=0)

    def known_set(self) -> set:
        """Set of all true triplets (for *filtered* ranking metrics), built
        once and cached; the splits are immutable after construction."""
        if self._known is None:
            self._known = {tuple(t) for t in self.all_triplets.tolist()}
        return self._known

    def known_index(self) -> tuple:
        """``(by_hr, by_rt)`` group indices over :meth:`known_set`:
        ``by_hr[(h, r)]`` is the sorted list of known tails of ``(h, r)``,
        ``by_rt[(r, t)]`` the sorted known heads.  Built once and cached."""
        if self._known_index is None:
            by_hr: Dict[tuple, list] = {}
            by_rt: Dict[tuple, list] = {}
            for (h, r, t) in self.known_set():
                by_hr.setdefault((h, r), []).append(t)
                by_rt.setdefault((r, t), []).append(h)
            for d in (by_hr, by_rt):
                for k in d:
                    d[k].sort()
            self._known_index = (by_hr, by_rt)
        return self._known_index

    def eval_filter_candidates(
        self, max_fanout: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded known-candidate id arrays for filtered ranking of the test
        split: ``(tail_cands, head_cands)``, each ``(n_test, P)`` int32,
        padded with ``n_entities`` (an out-of-table id the device engine
        maps to +inf energy).

        Row ``i`` of ``tail_cands`` holds the known tails of ``(h_i, r_i)``
        and ``head_cands`` the known heads of ``(r_i, t_i)``.  ``P`` is the
        largest group size; ``max_fanout`` caps it, keeping each row's
        first (sorted) candidates and warning once with the dropped count
        (filtered ranks of affected queries become upper bounds).  Built
        once per ``max_fanout`` and cached."""
        if max_fanout not in self._filter_cands:
            by_hr, by_rt = self.known_index()
            tail_groups = [by_hr[(h, r)] for h, r, _ in self.test.tolist()]
            head_groups = [by_rt[(r, t)] for _, r, t in self.test.tolist()]
            tails, dropped_t = _pad_groups(
                tail_groups, self.n_entities, max_fanout)
            heads, dropped_h = _pad_groups(
                head_groups, self.n_entities, max_fanout)
            dropped = dropped_t + dropped_h
            if dropped:
                warn_fresh(
                    f"max_fanout={max_fanout} truncates the filtered-known "
                    f"candidate masks: {dropped} known candidates dropped "
                    f"across {len(self.test)} test queries "
                    f"({dropped_t} tail-side, {dropped_h} head-side) — "
                    "filtered ranks of the affected queries become upper "
                    "bounds.  Raise max_fanout (or leave it None) for exact "
                    "filtering.", stacklevel=2)
            self._filter_cands[max_fanout] = (tails, heads)
        return self._filter_cands[max_fanout]

    def known_candidate_masks(
        self, pairs: np.ndarray, side: str
    ) -> np.ndarray:
        """Padded known-entity ids for arbitrary serve-time queries.

        ``pairs`` is ``(B, 2)``: ``(h, r)`` rows for ``side="tail"`` (known
        tails) or ``(r, t)`` rows for ``side="head"`` (known heads).  Output
        is ``(B, P)`` int32 padded with ``n_entities``, the layout of
        :meth:`eval_filter_candidates`; unseen pairs get an all-pad row."""
        if side not in ("tail", "head"):
            raise ValueError(f"bad side {side!r}")
        by_hr, by_rt = self.known_index()
        index = by_hr if side == "tail" else by_rt
        groups = [
            index.get((int(a), int(b)), [])
            for a, b in np.asarray(pairs, np.int64)
        ]
        return _pad_groups(groups, self.n_entities, None)[0]

    def fingerprint(self) -> Dict[str, object]:
        """Content identity of this graph: sizes plus a short sha256 of each
        split's triplet array — the same digests the reference computes,
        so artifacts saved by either package validate in the other."""

        def digest(a: np.ndarray) -> str:
            a = np.ascontiguousarray(np.asarray(a, np.int32))
            return hashlib.sha256(a.tobytes()).hexdigest()[:16]

        return {
            "n_entities": self.n_entities,
            "n_relations": self.n_relations,
            "train": digest(self.train),
            "valid": digest(self.valid),
            "test": digest(self.test),
        }

    def tc_negatives(self, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Corrupted valid/test counterparts for triplet classification,
        built once per seed and cached (``core/eval._tc_negatives``: both
        eval engines read the same draws, which their exact agreement
        depends on).  The draws come from a ``torch.Generator`` seeded with
        ``seed``, so they differ from the reference's ``jax.random`` ones;
        parity tests put the reference's pair into this cache."""
        if seed not in self._tc_negatives:
            from repro_torch.core import eval as kg_eval

            self._tc_negatives[seed] = kg_eval._tc_negatives(
                self.valid, self.test, self.n_entities, seed)
        return self._tc_negatives[seed]

    def invalidate_caches(self) -> None:
        """Drop every lazily built known-triplet structure.  The splits are
        immutable by convention, so no supported path needs this; code that
        mutates a graph in place must call it, or filtered ranks and
        classification negatives keep the old candidate sets.  The online
        tier goes through :meth:`extend`, which returns a fresh graph."""
        self._known = None
        self._known_index = None
        self._filter_cands = {}
        self._tc_negatives = {}

    def extend(
        self,
        new_train: np.ndarray,
        n_entities: Optional[int] = None,
        n_relations: Optional[int] = None,
    ) -> "KG":
        """A **new** graph with ``new_train`` appended to the train split,
        its counts grown to cover every id the delta names (or set to the
        explicit ``n_entities`` / ``n_relations``, which must cover them).
        A fresh instance starts with cold caches and a different train
        digest, so no filter, negative or served answer of the old graph
        is reused."""
        new_train = np.asarray(new_train, np.int32).reshape(-1, 3)
        n_ent, n_rel = self.n_entities, self.n_relations
        if len(new_train):
            n_ent = max(n_ent, int(new_train[:, (0, 2)].max()) + 1)
            n_rel = max(n_rel, int(new_train[:, 1].max()) + 1)
        if n_entities is not None:
            if n_entities < n_ent:
                raise ValueError(
                    f"n_entities={n_entities} does not cover the delta's "
                    f"max entity id ({n_ent - 1})")
            n_ent = n_entities
        if n_relations is not None:
            if n_relations < n_rel:
                raise ValueError(
                    f"n_relations={n_relations} does not cover the delta's "
                    f"max relation id ({n_rel - 1})")
            n_rel = n_relations
        return KG(
            n_entities=n_ent,
            n_relations=n_rel,
            train=np.concatenate([self.train, new_train], axis=0),
            valid=self.valid,
            test=self.test,
        )


def _pad_groups(
    groups: list, pad_id: int, max_fanout: Optional[int]
) -> Tuple[np.ndarray, int]:
    """Dense ``(len(groups), P)`` int32 array from ragged id lists, padded
    with ``pad_id``; returns the array and the count of ids dropped by the
    ``max_fanout`` cap."""
    widest = max((len(g) for g in groups), default=0)
    P = widest if max_fanout is None else min(widest, max_fanout)
    P = max(P, 1)
    out = np.full((len(groups), P), pad_id, np.int32)
    dropped = 0
    for i, g in enumerate(groups):
        n = len(g)
        if n > P:
            dropped += n - P
            n = P
        out[i, :n] = g[:n]
    return out, dropped


# ---------------------------------------------------------------------------
# Loading (Freebase/NELL-style TSV)
# ---------------------------------------------------------------------------

def load_tsv_dir(path: str) -> KG:
    """Load ``train.txt``/``valid.txt``/``test.txt`` of ``h\\tr\\tt`` string
    triplets (the FB15k / WN18 / NELL release layout), building id maps in
    first-seen order."""
    ent2id: Dict[str, int] = {}
    rel2id: Dict[str, int] = {}

    def get(d: Dict[str, int], k: str) -> int:
        if k not in d:
            d[k] = len(d)
        return d[k]

    def read(fname: str) -> np.ndarray:
        rows = []
        full = os.path.join(path, fname)
        if not os.path.exists(full):
            return np.zeros((0, 3), np.int32)
        with open(full) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 3:
                    continue
                h, r, t = parts
                rows.append((get(ent2id, h), get(rel2id, r), get(ent2id, t)))
        return np.asarray(rows, np.int32)

    train = read("train.txt")
    valid = read("valid.txt")
    test = read("test.txt")
    return KG(len(ent2id), len(rel2id), train, valid, test)


# ---------------------------------------------------------------------------
# Synthetic planted-translation KG
# ---------------------------------------------------------------------------

def synthetic_kg(
    seed: int,
    n_entities: int = 2000,
    n_relations: int = 20,
    n_triplets: int = 20000,
    latent_dim: int = 16,
    noise: float = 0.05,
    valid_frac: float = 0.05,
    test_frac: float = 0.05,
) -> KG:
    """Generate a KG whose triplets satisfy ``z_h + g_r ≈ z_t`` by
    construction: entities on the unit sphere in ``latent_dim``, each
    relation a random small translation; each triplet samples (h, r),
    displaces, adds noise and connects to the nearest entity."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n_entities, latent_dim)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    g = rng.normal(scale=0.5, size=(n_relations, latent_dim)).astype(np.float32)

    # over-sample then dedupe to hit the requested count
    n_draw = int(n_triplets * 1.6)
    h = rng.integers(0, n_entities, size=n_draw)
    r = rng.integers(0, n_relations, size=n_draw)
    target = z[h] + g[r] + rng.normal(scale=noise, size=(n_draw, latent_dim))
    # nearest entity by blocked L2 search (keeps memory bounded).  The
    # reference's expression ``tt - 2.0 * tb @ z.T + zz``, operation for
    # operation, evaluated in place and on several threads (numpy drops
    # the GIL): the same argmin, five times sooner at FB15k size.
    t = np.empty((n_draw,), np.int64)
    block = 4096
    zz = np.sum(z * z, axis=1)[None, :]

    def nearest(i: int) -> None:
        tb = target[i : i + block]
        d = (2.0 * tb) @ z.T
        np.subtract(np.sum(tb * tb, axis=1, keepdims=True), d, out=d)
        d += zz
        t[i : i + block] = np.argmin(d, axis=1)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(nearest, range(0, n_draw, block)))

    triplets = np.stack([h, r, t], axis=1).astype(np.int32)
    triplets = triplets[triplets[:, 0] != triplets[:, 2]]        # no self loops
    triplets = np.unique(triplets, axis=0)
    rng.shuffle(triplets)
    triplets = triplets[:n_triplets]

    n_valid = int(len(triplets) * valid_frac)
    n_test = int(len(triplets) * test_frac)
    valid, test, train = (
        triplets[:n_valid],
        triplets[n_valid : n_valid + n_test],
        triplets[n_valid + n_test :],
    )
    return KG(n_entities, n_relations, train, valid, test)


# ---------------------------------------------------------------------------
# Balanced partitioning (the paper's "several balanced subsets")
# ---------------------------------------------------------------------------

def partition_balanced(
    seed: int, triplets: np.ndarray, n_workers: int
) -> np.ndarray:
    """Shuffle + round-robin split into ``n_workers`` equal subsets: a
    dense ``(W, N//W, 3)`` array (the tail remainder is dropped so every
    worker takes identical step counts, the paper's balance requirement)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(triplets))
    per = len(triplets) // n_workers
    idx = perm[: per * n_workers].reshape(n_workers, per)
    return triplets[idx]


def partition_stratified(
    seed: int, triplets: np.ndarray, n_workers: int
) -> np.ndarray:
    """Relation-stratified balanced split: each worker sees (about) the
    full relation distribution."""
    rng = np.random.default_rng(seed)
    order = np.lexsort((rng.random(len(triplets)), triplets[:, 1]))
    per = len(triplets) // n_workers
    chunks = [order[w::n_workers][:per] for w in range(n_workers)]
    return triplets[np.stack(chunks)]


def entity_degrees(triplets: np.ndarray, n_entities: int) -> np.ndarray:
    """Per-entity degree (head + tail occurrences) over a triplet set."""
    t = np.asarray(triplets)
    deg = np.bincount(t[:, 0], minlength=n_entities)
    deg += np.bincount(t[:, 2], minlength=n_entities)
    return deg[:n_entities].astype(np.int64)


def triplet_strata(
    triplets: np.ndarray, n_entities: int, n_buckets: int = 8
) -> np.ndarray:
    """Quantile-bucket each triplet by its degree score ``deg[h] + deg[t]``
    (int32 labels, ``(N,)``): the strata of the degree-stratified
    partitioner.  Bucket edges are quantiles of this triplet set's scores,
    so the labels are a pure function of the triplets."""
    t = np.asarray(triplets)
    if len(t) == 0:
        return np.zeros((0,), np.int32)
    deg = entity_degrees(t, n_entities)
    score = deg[t[:, 0]] + deg[t[:, 2]]
    edges = np.quantile(score, np.linspace(0, 1, n_buckets + 1)[1:-1])
    return np.searchsorted(edges, score, side="right").astype(np.int32)


def partition_degree_stratified(
    seed: int, triplets: np.ndarray, n_workers: int, n_buckets: int = 8
) -> np.ndarray:
    """Degree-stratified balanced split: shuffle within each degree stratum
    (:func:`triplet_strata`) and deal the strata round-robin, so every
    worker gets the same hub/tail-entity mix."""
    t = np.asarray(triplets)
    n_entities = int(t[:, [0, 2]].max()) + 1 if len(t) else 0
    strata = triplet_strata(t, n_entities, n_buckets)
    rng = np.random.default_rng(seed)
    order = np.lexsort((rng.random(len(t)), strata))
    per = len(t) // n_workers
    chunks = [order[w::n_workers][:per] for w in range(n_workers)]
    return t[np.stack(chunks)]


def partition_overlap_min(
    seed: int, triplets: np.ndarray, n_workers: int
) -> np.ndarray:
    """Overlap-minimizing balanced split (greedy streaming): each triplet
    goes to the worker already holding the most triplets on its head and
    tail entities, minus a load penalty, under a hard cap of ``N // W`` per
    worker; ties go to the lowest worker id.  O(N·W) on the host."""
    t = np.asarray(triplets)
    rng = np.random.default_rng(seed)
    n_entities = int(t[:, [0, 2]].max()) + 1 if len(t) else 0
    per = len(t) // n_workers
    aff = np.zeros((n_entities, n_workers), np.float64)
    load = np.zeros(n_workers, np.int64)
    chunks: list = [[] for _ in range(n_workers)]
    assigned = 0
    for i in rng.permutation(len(t)):
        if assigned == per * n_workers:
            break
        h, tl = int(t[i, 0]), int(t[i, 2])
        score = aff[h] + aff[tl] - load / max(per, 1)
        score[load >= per] = -np.inf
        w = int(np.argmax(score))
        chunks[w].append(i)
        aff[h, w] += 1.0
        aff[tl, w] += 1.0
        load[w] += 1
        assigned += 1
    return t[np.array(chunks, dtype=np.int64)]


#: Host partitioner registry: ``MapReduceConfig.partition`` values.
PARTITIONERS = {
    "balanced": partition_balanced,
    "stratified": partition_stratified,
    "degree": partition_degree_stratified,
    "overlap": partition_overlap_min,
}


def epoch_batches(
    seed: int,
    epoch: int,
    partitioned: np.ndarray,     # (W, N_w, 3)
    batch_size: int,
) -> np.ndarray:
    """Deterministic minibatches for one epoch, ``(W, S, B, 3)`` int32: a
    pure function of (seed, epoch).  ``S = N_w // batch_size``; the
    trailing ``N_w % batch_size`` triplets of each worker's permutation sit
    out of the epoch, and the per-epoch reshuffle rotates which."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    W, N_w, _ = partitioned.shape
    S = N_w // batch_size
    out = np.empty((W, S, batch_size, 3), np.int32)
    for w in range(W):
        perm = rng.permutation(N_w)[: S * batch_size]
        out[w] = partitioned[w][perm].reshape(S, batch_size, 3)
    return out


# ---------------------------------------------------------------------------
# Device pipeline: on-device epoch batching and re-partitioning
# ---------------------------------------------------------------------------

def device_worker_batches(
    key: keys_lib.Key,
    triplets: torch.Tensor,      # (N_w, 3) one worker's split, on device
    batch_size: int,
) -> torch.Tensor:
    """One worker's epoch batch grid, built on the triplets' device:
    ``(S, B, 3)``.  The permutation comes from ``key`` (callers fold in
    (epoch, worker)), so batches are a pure function of (seed, epoch,
    worker).  The host path's remainder rule: ``S = N_w // batch_size``,
    and the trailing ``N_w % batch_size`` of the permutation sit out."""
    n = triplets.shape[0]
    steps = n // batch_size
    perm = keys_lib.permutation(key, n, triplets.device)
    return triplets[perm[: steps * batch_size]].reshape(steps, batch_size, 3)


def device_epoch_batches(
    key: keys_lib.Key,
    partitioned: torch.Tensor,   # (W, N_w, 3) on device
    batch_size: int,
    workers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All workers' batch grids, ``(W, S, B, 3)``: worker ``w``'s is
    :func:`device_worker_batches` of ``fold_in(key, w)``, all W drawn and
    gathered at once.  ``workers`` (default ``arange(W)``) gives the rows'
    global worker ids, for a rank holding a block of the workers."""
    W, n, _ = partitioned.shape
    steps = n // batch_size
    dev = partitioned.device
    if workers is None:
        workers = torch.arange(W, device=dev)
    wkeys = keys_lib.fold_in(key, workers)
    perm = keys_lib.permutation(wkeys, n, dev)[:, : steps * batch_size]
    rows = torch.gather(partitioned, 1, perm[..., None].expand(-1, -1, 3))
    return rows.reshape(W, steps, batch_size, 3)


def repartition_perm(key: keys_lib.Key, n: int, round_idx: int,
                     device=None) -> torch.Tensor:
    """The global triplet permutation of re-partition round ``round_idx``.
    Round 0 is the identity (the original host partition), so a
    ``repartition_every`` past the run's end changes nothing."""
    if round_idx == 0:
        return torch.arange(n, device=device)
    return keys_lib.permutation(key, n, device)


def repartition_perm_stratified(
    key: keys_lib.Key,
    strata: torch.Tensor,        # (n,) int per-triplet stratum labels
    n_workers: int,
    round_idx: int,
    uniform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratum-preserving re-partition permutation (degree partitioner):
    shuffle within each stratum (the order of ``(stratum, draw, index)``,
    as the reference's ``lexsort((u, strata))``), then deal the stratified
    order round-robin, ``order.reshape(n_w, W).T``, so worker ``w`` gets
    rows ``order[w::W]`` and keeps its degree mix.  ``uniform`` (``(n,)``)
    replaces the port's own draw, which is the key's 32-bit
    :func:`keys.random_bits`.  Round 0 is the identity."""
    n = strata.shape[0]
    if round_idx == 0:
        return torch.arange(n, device=strata.device)
    u = uniform if uniform is not None else keys_lib.random_bits(
        key, n, strata.device)
    by_draw = torch.argsort(u.to(strata.device), stable=True)
    order = by_draw[torch.argsort(strata[by_draw], stable=True)]
    return order.reshape(n // n_workers, n_workers).T.reshape(-1)


def device_repartition(
    key: keys_lib.Key,
    partitioned: torch.Tensor,   # (W, N_w, 3) on device
    round_idx: int,
    strata: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Re-split the whole triplet set across the workers on its device:
    the flattened partition permuted by round ``round_idx``'s
    :func:`repartition_perm` (``strata`` given:
    :func:`repartition_perm_stratified`), ``(W, N_w, 3)``.  A pure function
    of (key, round); callers fold the round into the key."""
    W, n_w, _ = partitioned.shape
    if round_idx == 0:
        return partitioned
    flat = partitioned.reshape(W * n_w, 3)
    if strata is None:
        perm = repartition_perm(key, W * n_w, round_idx, flat.device)
    else:
        perm = repartition_perm_stratified(key, strata, W, round_idx)
    return flat[perm].reshape(W, n_w, 3)
