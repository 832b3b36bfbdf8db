"""Corrupted-triplet construction (paper Eq. 2), port of
``repro.core.negative``.

Delta'_{(h,r,t)} = {(h',r,t) | h' in E, h' != h} U {(h,r,t') | t' in E, t' != t}

Each training triplet has EITHER its head OR its tail corrupted:
 - 'unif': a fair coin (TransE / the paper),
 - 'bern': a per-relation Bernoulli from head/tail multiplicity statistics
   (TransH; fewer false negatives on 1-to-N / N-to-1 relations).

The reference draws its coin flips and offsets from ``jax.random``
threefry keys; the port does not reimplement threefry.  The draws are
arguments instead: pass them to reproduce a given draw (the parity tests
pass the reference's), or a seeded CPU ``torch.Generator`` to draw fresh
ones — on the CPU, so one seed gives the same negatives on every device.
The device pipeline draws them on its device from counter-based keys
instead (:func:`device_draws`), the same bits on every device too.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import keys


def _draw_offsets(shape, n_entities: int, generator: torch.Generator):
    return torch.randint(1, n_entities, shape, generator=generator)


def _corrupt(triplets, n_entities, corrupt_head, offset):
    dev = triplets.device
    corrupt_head = torch.as_tensor(corrupt_head, device=dev).bool()
    offset = torch.as_tensor(offset, device=dev).long()
    trip = triplets.long()
    h, r, t = trip[..., 0], trip[..., 1], trip[..., 2]
    h2 = torch.where(corrupt_head, (h + offset) % n_entities, h)
    t2 = torch.where(corrupt_head, t, (t + offset) % n_entities)
    return torch.stack([h2, r, t2], dim=-1).to(triplets.dtype)


def corrupt_unif(
    triplets: torch.Tensor,
    n_entities: int,
    *,
    generator: Optional[torch.Generator] = None,
    corrupt_head: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Corrupt head or tail uniformly at random.

    ``corrupt_head`` (B,) bool picks the side (a fair coin when drawn);
    ``offset`` (B,) in ``[1, E-1]`` shifts the replaced id mod ``E``, so it
    always differs from the original (Eq. 2's h' != h) without rejection
    loops.  Draws not passed in come from ``generator`` (a CPU generator,
    seed 0 when none is given) and are moved to the triplets' device."""
    B = triplets.shape[0]
    if corrupt_head is None or offset is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if corrupt_head is None:
            corrupt_head = torch.rand(B, generator=generator) < 0.5
        if offset is None:
            offset = _draw_offsets((B,), n_entities, generator)
    return _corrupt(triplets, n_entities, corrupt_head, offset)


def bernoulli_stats(triplets: np.ndarray, n_relations: int) -> np.ndarray:
    """tph/(tph+hpt) per relation — the probability of corrupting the HEAD
    (TransH's 'bern' sampling), float32 ``(R,)``; relations without
    triplets get 0.5.  numpy, the reference's arithmetic: float64 counts,
    one final float32 rounding."""
    t = np.asarray(triplets)
    probs = np.full((n_relations,), 0.5, np.float32)
    if len(t) == 0:
        return probs
    r = t[:, 1].astype(np.int64)
    n = np.bincount(r, minlength=n_relations)[:n_relations].astype(np.float64)

    def distinct_per_rel(ent: np.ndarray) -> np.ndarray:
        codes = np.unique(ent.astype(np.int64) * n_relations + r)
        return np.bincount(
            codes % n_relations, minlength=n_relations
        )[:n_relations].astype(np.float64)

    uh = distinct_per_rel(t[:, 0])    # distinct heads per relation
    ut = distinct_per_rel(t[:, 2])    # distinct tails per relation
    seen = n > 0
    tph = n[seen] / np.maximum(uh[seen], 1.0)   # tails-per-head
    hpt = n[seen] / np.maximum(ut[seen], 1.0)   # heads-per-tail
    probs[seen] = (tph / (tph + hpt)).astype(np.float32)
    return probs


def corrupt_bern(
    triplets: torch.Tensor,
    n_entities: int,
    head_prob_per_rel: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    uniform: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """'bern' corruption: the head is replaced where ``uniform < p[r]``
    (``uniform`` in [0, 1), one per triplet, drawn when not passed), else
    the tail; ``offset`` as in :func:`corrupt_unif`."""
    B = triplets.shape[0]
    if uniform is None or offset is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if uniform is None:
            uniform = torch.rand(B, generator=generator)
        if offset is None:
            offset = _draw_offsets((B,), n_entities, generator)
    p = torch.as_tensor(head_prob_per_rel, device=triplets.device)
    u = torch.as_tensor(uniform, device=triplets.device)
    return _corrupt(triplets, n_entities, u < p[triplets[..., 1].long()],
                    offset)


def device_draws(key, shape, n_entities: int, device=None) -> tuple:
    """The device pipeline's draws for one worker's negatives, ``(uniform,
    offset)`` of ``shape``: counter-based (``core/keys.py``) from
    ``fold_in(key, 0)`` and ``fold_in(key, 1)``, on ``device``, the same
    bits on every device.  ``key`` may be a tensor of per-worker keys,
    which then lead ``shape``: ``(W,)`` keys for ``(W, S, B)`` draws."""
    lead = key.dim() if isinstance(key, torch.Tensor) else 0
    n = math.prod(shape[lead:])
    uniform = keys.uniform(keys.fold_in(key, 0), n, device).reshape(shape)
    offset = keys.randint(keys.fold_in(key, 1), n, 1, n_entities,
                          device).reshape(shape)
    return uniform, offset


def make_negatives(
    pos_batches: torch.Tensor,   # (..., B, 3), e.g. (S, B, 3) or (W, S, B, 3)
    n_entities: int,
    sampling: str = "unif",
    head_prob_per_rel: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    uniform: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Corrupted counterparts of stacked batches of any leading rank.

    The draws are one ``uniform`` in [0, 1) and one ``offset`` in
    ``[1, E-1]`` per triplet (``pos_batches.shape[:-1]``): the head is
    replaced where ``uniform < 0.5`` ('unif') or ``uniform < p[r]``
    ('bern').  (``jax.random.bernoulli(key, 0.5)`` is
    ``uniform(key) < 0.5``, so the reference's draws carry across as they
    are.)  Draws not passed in come from ``generator`` on the CPU."""
    if sampling not in ("unif", "bern"):
        raise ValueError(f"unknown sampling {sampling!r}")
    if sampling == "bern" and head_prob_per_rel is None:
        raise ValueError("'bern' sampling requires head_prob_per_rel")
    shape = pos_batches.shape[:-1]
    if uniform is None or offset is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if uniform is None:
            uniform = torch.rand(shape, generator=generator)
        if offset is None:
            offset = _draw_offsets(shape, n_entities, generator)
    if sampling == "unif":
        u = torch.as_tensor(uniform, device=pos_batches.device)
        return corrupt_unif(pos_batches, n_entities, corrupt_head=u < 0.5,
                            offset=offset)
    return corrupt_bern(pos_batches, n_entities, head_prob_per_rel,
                        uniform=uniform, offset=offset)
