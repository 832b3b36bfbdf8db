"""Small cross-cutting helpers with no better home.

``warn_fresh`` exists because Python's warning machinery dedupes
"default"-action warnings on (message, category, lineno) in a per-module
registry that lives for the whole *process*: a data-quality warning (the
``max_fanout`` eval truncation in ``data/kg.KG``) would fire for the first
evaluation and be swallowed for every later one in the same process, even
though each drops its own counts.  These are once-per-*call* reports.

``ordered_index_add`` exists because ``index_add_`` on a CUDA tensor adds
with float atomics, in an order that changes from run to run; ``sqrt_rn``
because ``torch.sqrt`` of a float32 CPU tensor is not always correctly
rounded (about 0.6 % of inputs come out one ulp off), while the card's and
the CUDA kernels' (``__fsqrt_rn``) are; ``pairwise_sum`` and
``pairwise_mean`` because ``torch.sum`` and ``torch.mean`` sum in another
order on the card than on the CPU.
"""
from __future__ import annotations

import sys
import warnings

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` correctly rounded to ``x``'s dtype on every device: the
    root taken in float64 and rounded once to float32 is the correctly
    rounded float32 root (float64 carries more than twice float32's bits),
    the same bits as ``__fsqrt_rn`` on the card."""
    return torch.sqrt(x.double()).to(x.dtype)


def exact_div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` for a Python number ``n``, one correctly rounded division
    on every device (a CUDA tensor divided by a Python scalar is multiplied
    by its reciprocal instead, which differs in the last bit unless ``n``
    is a power of two).  The divisor is filled on the device, not copied
    from the host, so the division makes no host sync."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def pairwise_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` with the same bits on every device: ``x`` padded
    with ``+0.0`` to a power-of-two length, summed as a balanced tree of
    pairwise additions (``x[0::2] + x[1::2]`` a level, one rounding per
    addition).  ``torch.sum`` reduces in one order on the CPU and in
    another on the card, so its last bit may differ between them."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.cat([x, x.new_zeros((width - n,) + x.shape[1:])])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def pairwise_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Mean over ``dim`` with the same bits on every device:
    :func:`pairwise_sum`, then one :func:`exact_div`."""
    return exact_div(pairwise_sum(x, dim), x.shape[dim])


def worker_offsets(ids: torch.Tensor, *sizes: int) -> tuple:
    """For stacked ``(W, B, c)`` ids, one ``(W, 1)`` offset ``w·N`` per
    table size ``N``: worker ``w``'s id plus its offset is its row of a
    stacked ``(W, N, k)`` table viewed as ``(W·N, k)``.  This flat layout
    lets one kernel launch, or one plain gather, serve all W workers, each
    on its own rows."""
    w = torch.arange(ids.shape[0], device=ids.device)[:, None]
    return tuple(w * n for n in sizes)


def ordered_index_add(
    target: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """``target`` with ``vals[i]`` added to row ``rows[i]`` for every ``i``,
    out of place, each row's additions taken one at a time in the order of
    ``rows`` (a sequential scatter-add, one rounding per addition), on any
    device: the same bits on every run and on the CPU and the card.

    The rows are sorted stably; pass ``p`` adds the ``p``-th contribution
    of every row at once, so there are as many passes as the largest
    number of contributions to one row."""
    out = target.clone()
    n = rows.numel()
    if n == 0:
        return out
    srows, order = torch.sort(rows.reshape(-1), stable=True)
    svals = vals.reshape((n,) + vals.shape[rows.dim():])[order]
    pos = torch.arange(n, device=rows.device)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = srows[1:] != srows[:-1]
    seg_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = pos - seg_start                  # place of i within its row's run
    by_rank = torch.sort(rank, stable=True).indices
    lo = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[lo:lo + c]            # rows distinct within one pass
        r = srows[sel]
        out[r] = out[r] + svals[sel]
        lo += c
    return out


def warn_fresh(msg: str, category: type = UserWarning,
               stacklevel: int = 2) -> None:
    """``warnings.warn(msg, category, stacklevel=...)`` minus the
    per-process once-only dedupe: each call hands ``warn_explicit`` a
    fresh registry, so every call surfaces its own report while remaining
    an ordinary warning for filters, ``-W error`` and ``pytest.warns``."""
    frame = sys._getframe(stacklevel)
    warnings.warn_explicit(
        msg,
        category,
        frame.f_code.co_filename,
        frame.f_lineno,
        module=frame.f_globals.get("__name__", "<unknown>"),
        registry={},
    )
