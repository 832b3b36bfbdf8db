"""Plain PyTorch versions of the port's kernels.

Each is the semantic ground truth its kernel is held against: the CPU
tests run it (the kernels' wrappers take it for CPU tensors), and
``chip_smoke.py`` compares each kernel with it on the card, on the same
inputs.
"""
from __future__ import annotations

import torch

from repro_torch.util import ordered_index_add, sqrt_rn, worker_offsets

# (B, chunk) fp32 intermediates stay under 2**25 elements (128 MB)
_CHUNK_ELEMS = 1 << 25


def _check_norm(norm: str) -> None:
    if norm not in ("l1", "l2"):
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")


def _gather5(ent, rel, idx):
    """The five fp32 row sets ``h, r, t, nh, nt`` of ``idx`` (``(..., 5)``):
    from ``(E, k)`` / ``(R, k)`` tables, or from worker ``w``'s rows of
    stacked ``(W, E, k)`` / ``(W, R, k)`` tables for ``idx[w]``."""
    idx = idx.long()
    if ent.dim() == 2:
        rows = lambda table, col: table[idx[..., col]]
    else:
        w = torch.arange(idx.shape[0], device=idx.device)[:, None]
        rows = lambda table, col: table[w, idx[..., col]]
    return tuple(rows(tab, col).float() for tab, col in
                 ((ent, 0), (rel, 1), (ent, 2), (ent, 3), (ent, 4)))


def _in_order_norm(x: torch.Tensor, norm: str) -> torch.Tensor:
    """``Σ_j |x_j|`` or ``sqrt(Σ_j x_j² + 1e-12)`` over the last axis,
    summed ``j = 0 .. k-1`` in order, one rounding per operation."""
    terms = x.abs() if norm == "l1" else x * x
    acc = terms[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + terms[..., j]
    return acc if norm == "l1" else sqrt_rn(acc + 1e-12)


def transe_score_ref(
    ent: torch.Tensor,         # (E, k) or (W, E, k)
    rel: torch.Tensor,         # (R, k) or (W, R, k)
    idx: torch.Tensor,         # (B, 5) or (W, B, 5) ints [h, r, t, nh, nt]
    margin: float,
    norm: str,
):
    """TransE pos/neg scoring and hinge, ``(loss, d_pos, d_neg)`` each
    ``idx.shape[:-1]`` fp32: ``u = (h + r) - t``, ``v = (nh + r) - nt``,
    in-order L1/L2 norms, ``loss = max((margin + d_pos) - d_neg, 0)``.

    The arithmetic of ``kernels/csrc/transe_score.cu``'s forward, operation
    for operation (inputs in fp32), and of ``TransE.energy`` /
    ``per_pair_loss`` on fp32 tables."""
    _check_norm(norm)
    h, r, t, nh, nt = _gather5(ent, rel, idx)
    d_pos = _in_order_norm((h + r) - t, norm)
    d_neg = _in_order_norm((nh + r) - nt, norm)
    loss = torch.clamp_min((margin + d_pos) - d_neg, 0.0)
    return loss, d_pos, d_neg


def _transe_grads(ent, rel, idx, g, loss, d_pos, d_neg, norm):
    """Per-triplet gradients ``(gu, gv)`` of the hinge with respect to
    ``u = (h + r) - t`` and ``v = (nh + r) - nt``, fp32 ``(..., k)``: the
    reference's closed form (``repro/kernels/ops.py::_bwd``) with the
    upstream gradient ``g`` given per triplet."""
    h, r, t, nh, nt = _gather5(ent, rel, idx)
    u = (h + r) - t
    v = (nh + r) - nt
    scale = (g.float() * (loss > 0).float())[..., None]
    if norm == "l1":
        su = (u > 0).float() - (u < 0).float()
        sv = (v > 0).float() - (v < 0).float()
    else:
        su = u / (d_pos + 1e-12)[..., None]
        sv = v / (d_neg + 1e-12)[..., None]
    return su * scale, -sv * scale


def scatter_rows(ent, rel, idx):
    """The output rows the backward scatters into, in its fixed order:
    ``(ent_rows (4n,), rel_rows (n,))`` int64 over the flattened ``n``
    triplets, entity rows ``[h…, t…, nh…, nt…]`` as in the reference's
    ``_bwd``.  Worker ``w``'s ids are offset by ``w·E`` (``w·R``), the
    rows of its slice of a ``(W, E, k)`` gradient."""
    idx = idx.long()
    if ent.dim() == 3:
        eo, ro = worker_offsets(idx, ent.shape[1], rel.shape[1])
        idx = idx + torch.stack([eo, ro, eo, eo, eo], dim=-1)
    flat = idx.reshape(-1, 5)
    ent_rows = torch.cat([flat[:, 0], flat[:, 2], flat[:, 3], flat[:, 4]])
    return ent_rows, flat[:, 1]


def transe_score_bwd_ref(
    ent, rel, idx,
    g: torch.Tensor,           # (B,) or (W, B) upstream gradient per triplet
    loss, d_pos, d_neg,        # the forward's outputs
    norm: str,
):
    """Dense ``(d_ent, d_rel)`` in the tables' shapes and dtype: ``gu`` added
    to row h, ``-gu`` to t, ``gv`` to nh, ``-gv`` to nt, ``gu + gv`` to r.

    Each row's contributions are summed one at a time from ``+0.0`` in the
    order of :func:`scatter_rows` (``util.ordered_index_add``), the order
    of ``kernels/csrc/transe_score.cu``'s backward, so the two agree
    bitwise and a row no triplet references stays exactly ``+0.0``."""
    _check_norm(norm)
    gu, gv = _transe_grads(ent, rel, idx, g, loss, d_pos, d_neg, norm)
    k = ent.shape[-1]
    gu, gv = gu.reshape(-1, k), gv.reshape(-1, k)
    ent_rows, rel_rows = scatter_rows(ent, rel, idx)
    n_ent = ent.shape[0] * ent.shape[1] if ent.dim() == 3 else ent.shape[0]
    n_rel = rel.shape[0] * rel.shape[1] if rel.dim() == 3 else rel.shape[0]
    zeros = lambda n: torch.zeros(n, k, dtype=torch.float32, device=gu.device)
    d_ent = ordered_index_add(zeros(n_ent), ent_rows,
                              torch.cat([gu, -gu, gv, -gv]))
    d_rel = ordered_index_add(zeros(n_rel), rel_rows, gu + gv)
    return (d_ent.reshape(ent.shape).to(ent.dtype),
            d_rel.reshape(rel.shape).to(rel.dtype))


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
            d = sqrt_rn(d2.clamp_min(0.0) + 1e-12)
        counts += (d < gold).sum(dim=1)
    return counts.to(torch.int32)
