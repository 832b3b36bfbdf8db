"""Reduce-phase merge strategies (paper §3.1.2), port of the dense stacked
half of ``repro.core.merge``.

After the Map phase, W workers hold W inconsistent copies of each
embedding table.  The paper Reduces the W vectors of each key by:

  * ``random``            — one worker's vector, picked at random,
  * ``average``           — the mean,
  * ``miniloss``          — the vector of the worker with the smallest loss.

Each comes in the reference's two refinements: per-key *touch-aware*
variants, in which only the workers whose subset updated the key take
part (``random``, ``average``, ``miniloss_perkey``), and the literal global
ones (``average_all``: plain mean over all workers; ``miniloss_global``:
the worker with the smallest mean loss wins every key).

Tables carry a leading worker axis, ``(W, N, k)``, with per-key stats
``counts`` / ``losses`` ``(W, N)`` and ``worker_loss`` ``(W,)``.  Sums over
workers run in worker order (:func:`worker_sum`), so a merge gives the
same bits on the CPU and the card.  The collective, sparse, sharded and
stale merges are not ported yet (ROADMAP.md queue 1, items 11-12).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.util import exact_div

STRATEGIES = (
    "random",
    "average",
    "average_all",
    "miniloss_perkey",
    "miniloss_global",
)

_BIG = 1e30


def worker_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Sum over the leading worker axis, taken ``((x_0 + x_1) + x_2) + …``."""
    acc = stacked[0]
    for w in range(1, stacked.shape[0]):
        acc = acc + stacked[w]
    return acc


def worker_mean(stacked: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker axis: :func:`worker_sum` over W."""
    return exact_div(worker_sum(stacked), stacked.shape[0])


def _select_by_priority_stacked(
    stacked: torch.Tensor, priority: torch.Tensor
) -> torch.Tensor:
    """Per key, the row of the worker with the highest priority (the lowest
    worker id among ties).  ``stacked``: (W, N, k); ``priority``: (W, N)
    -> (N, k)."""
    winner = torch.argmax(priority, dim=0)                      # (N,)
    index = winner[None, :, None].expand(1, *stacked.shape[1:])
    return stacked.gather(0, index)[0]


def merge_average_all_stacked(stacked: torch.Tensor) -> torch.Tensor:
    return worker_mean(stacked)


def merge_average_stacked(
    stacked: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Touch-count-weighted mean; keys untouched everywhere keep the plain
    mean (all copies are identical there, so it is the anchor value)."""
    w = counts[..., None]                                       # (W, N, 1)
    total = worker_sum(w)
    weighted = worker_sum(stacked * w)
    plain = worker_mean(stacked)
    return torch.where(total > 0, weighted / torch.clamp_min(total, 1.0),
                       plain)


def random_priorities(
    generator: torch.Generator, W: int, N: int, device=None
) -> torch.Tensor:
    """Per-worker uniform priorities ``(W, N)`` for the ``random``
    strategy, drawn on the CPU from ``generator`` (the reference draws
    them from worker-folded ``jax.random`` keys; tests pass those in)."""
    return torch.rand((W, N), generator=generator).to(device)


def merge_random_stacked(
    stacked: torch.Tensor, counts: torch.Tensor, priorities: torch.Tensor
) -> torch.Tensor:
    """Per key, a uniform choice among the workers that touched it: the
    toucher with the highest priority wins."""
    touched = counts > 0
    priority = torch.where(touched, priorities, -_BIG)
    # no toucher anywhere -> all copies identical; any worker will do
    priority = torch.where(touched.any(0)[None, :], priority, priorities)
    return _select_by_priority_stacked(stacked, priority)


def merge_miniloss_perkey_stacked(
    stacked: torch.Tensor, counts: torch.Tensor, losses: torch.Tensor
) -> torch.Tensor:
    """Per key: the worker with the smallest mean per-touch loss wins."""
    mean_loss = torch.where(counts > 0,
                            losses / torch.clamp_min(counts, 1.0), _BIG)
    return _select_by_priority_stacked(stacked, -mean_loss)


def merge_miniloss_global_stacked(
    stacked: torch.Tensor, worker_loss: torch.Tensor
) -> torch.Tensor:
    """The single worker with the smallest epoch loss wins every key (an
    index kernel, not a host read of the winner)."""
    return stacked.index_select(0, torch.argmin(worker_loss).reshape(1))[0]


def merge_stacked(
    strategy: str,
    stacked: torch.Tensor,
    counts: torch.Tensor,
    losses: Optional[torch.Tensor],
    worker_loss: torch.Tensor,
    priorities: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce one ``(W, N, k)`` table to ``(N, k)`` with ``strategy``;
    ``random`` needs ``priorities`` (:func:`random_priorities`),
    ``miniloss_perkey`` the per-key ``losses`` (no other strategy reads
    them)."""
    if strategy == "average":
        return merge_average_stacked(stacked, counts)
    if strategy == "average_all":
        return merge_average_all_stacked(stacked)
    if strategy == "random":
        if priorities is None:
            raise ValueError("'random' strategy needs priorities")
        return merge_random_stacked(stacked, counts, priorities)
    if strategy == "miniloss_perkey":
        if losses is None:
            raise ValueError("'miniloss_perkey' strategy needs losses")
        return merge_miniloss_perkey_stacked(stacked, counts, losses)
    if strategy == "miniloss_global":
        return merge_miniloss_global_stacked(stacked, worker_loss)
    raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
