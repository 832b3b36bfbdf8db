"""Knowledge-graph data: the host half of ``repro.data.kg``.

A ``KG`` holds a train/valid/test split of ``(h, r, t)`` id triplets as
numpy arrays, with the lazily built known-triplet structures both
evaluation engines filter with.  ``synthetic_kg`` generates a graph whose
triplets satisfy the TransE assumption ``z_h + g_r ≈ z_t`` by
construction; ``load_tsv_dir`` reads the FB15k / WN18 release layout.

Everything here is numpy and byte-for-byte the reference's arithmetic, so
the same arguments give the same arrays in both packages (the reference
module imports jax, which is why the port keeps its own copy).  The one
random draw that differs is ``KG.tc_negatives``: the reference draws with
``jax.random``, the port with a seeded ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

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
