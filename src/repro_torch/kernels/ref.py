"""Plain PyTorch versions of the port's kernels.

Each is the semantic ground truth its kernel is held against: the CPU
tests run it (the kernels' wrappers take it for CPU tensors), and
``chip_smoke.py`` compares each kernel with it on the card, on the same
inputs.
"""
from __future__ import annotations

import torch

# (B, chunk) fp32 intermediates stay under 2**25 elements (128 MB)
_CHUNK_ELEMS = 1 << 25


def rank_counts_ref(
    queries: torch.Tensor,     # (B, k) — h+r (tail side) or t-r (head side)
    table: torch.Tensor,       # (E, k)
    gold_d: torch.Tensor,      # (B,) distance of the gold entity
    norm: str,
) -> torch.Tensor:
    """Number of table rows strictly closer than the gold, per query:
    ``(B,)`` int32, rank = 1 + count.

    The arithmetic of ``kernels/csrc/rank_topk.cu``, operation for
    operation: inputs in fp32, sums over ``j = 0 .. k-1`` in order, one
    rounding per operation.  L1 is ``Σ|q_j - e_j|``; L2 is the Pallas
    kernel's expanded form ``sqrt(max(qq - 2·qe + ee, 0) + 1e-12)``.  The
    JAX oracle ``repro.kernels.ref.rank_counts_ref`` has no ``max(·, 0)``
    clamp: where ``qq - 2·qe + ee`` rounds below ``-1e-12`` (an entity at
    the query itself) it takes the root of a negative number, NaN, which
    never counts, while the Pallas kernel and this function get ``1e-6``,
    which counts."""
    if norm not in ("l1", "l2"):
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")
    q = queries.float()
    tab = table.float()
    gold = gold_d.float()[:, None]
    B, k = q.shape
    counts = torch.zeros(B, dtype=torch.int64, device=q.device)
    chunk = max(1, _CHUNK_ELEMS // max(B, 1))
    qq = None
    if norm == "l2":
        qq = q[:, 0] * q[:, 0]
        for j in range(1, k):
            qq = qq + q[:, j] * q[:, j]
    for e0 in range(0, tab.shape[0], chunk):
        cols = tab[e0 : e0 + chunk].t()                    # (k, n) view
        if norm == "l1":
            d = (q[:, 0, None] - cols[0][None, :]).abs()
            for j in range(1, k):
                d = d + (q[:, j, None] - cols[j][None, :]).abs()
        else:
            qe = q[:, 0, None] * cols[0][None, :]
            ee = cols[0] * cols[0]
            for j in range(1, k):
                qe = qe + q[:, j, None] * cols[j][None, :]
                ee = ee + cols[j] * cols[j]
            d2 = qq[:, None] - 2.0 * qe + ee[None, :]
            d = torch.sqrt(d2.clamp_min(0.0) + 1e-12)
        counts += (d < gold).sum(dim=1)
    return counts.to(torch.int32)
