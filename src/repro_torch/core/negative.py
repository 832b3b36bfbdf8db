"""Corrupted-triplet construction (paper Eq. 2), port of
``repro.core.negative`` — ``corrupt_unif`` only so far.

Delta'_{(h,r,t)} = {(h',r,t) | h' in E, h' != h} U {(h,r,t') | t' in E, t' != t}

The reference draws its coin flips and offsets from ``jax.random``
threefry keys; the port does not reimplement threefry.  The draws are
arguments instead: pass ``corrupt_head`` and ``offset`` to reproduce a
given draw (the parity tests pass the reference's), or a seeded
``torch.Generator`` to draw fresh ones.
"""
from __future__ import annotations

from typing import Optional

import torch


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
            offset = torch.randint(1, n_entities, (B,), generator=generator)
    dev = triplets.device
    corrupt_head = torch.as_tensor(corrupt_head, device=dev).bool()
    offset = torch.as_tensor(offset, device=dev).long()
    trip = triplets.long()
    h, r, t = trip[:, 0], trip[:, 1], trip[:, 2]
    new_h = (h + offset) % n_entities
    new_t = (t + offset) % n_entities
    h2 = torch.where(corrupt_head, new_h, h)
    t2 = torch.where(corrupt_head, t, new_t)
    return torch.stack([h2, r, t2], dim=1).to(triplets.dtype)
