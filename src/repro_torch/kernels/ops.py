"""Model-aware dispatch onto the port's kernels (port of
``repro.kernels.ops``).

Training: models with a fused path (``supports_fused_kernel``, currently
TransE) take their per-triplet margin loss through the ``transe_score``
kernels — forward and closed-form backward, as a
``torch.autograd.Function`` — and every other model takes torch autograd
of its plain ``per_pair_loss``.  The joint objective
(``KGConfig(negatives="joint")``) never comes here: it is plain PyTorch
for every model (``core/models/base.py``), as the reference's is plain
jnp.
CUDA tables launch the kernels; CPU tables take their plain versions.

Evaluation: fused models rank through the CUDA rank kernel; every other
model scores candidates with its plain PyTorch ``candidate_energies``.

Batches may carry a leading worker axis: ``(W, B, 3)`` triplets against
stacked ``(W, N, k)`` tables (see ``kernels/transe_score.py``), and the
losses then carry it too.
"""
from __future__ import annotations

import torch

from repro_torch.core.models import Params, get_model
from repro_torch.kernels import transe_score as ts

# ---------------------------------------------------------------------------
# Fused TransE margin loss (training path)
# ---------------------------------------------------------------------------


def _pack_idx(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """``[h, r, t, nh, nt]`` int32 rows from ``(..., 3)`` pos/neg triplets
    (a corruption keeps the relation)."""
    return torch.stack([pos[..., 0], pos[..., 1], pos[..., 2],
                        neg[..., 0], neg[..., 2]], dim=-1).to(torch.int32)


class _FusedPairLoss(torch.autograd.Function):
    """Per-pair hinge whose forward is the ``transe_score`` kernel and whose
    backward is the ``transe_score_bwd`` kernel, fed the upstream gradient
    of each pair (a mean over B arrives as ``g / B`` per pair, as in the
    reference's ``_bwd``).  ``check_ids`` goes to both wrappers."""

    @staticmethod
    def forward(ctx, ent, rel, idx, margin, norm, check_ids):
        loss, d_pos, d_neg = ts.transe_score(
            ent, rel, idx, margin=margin, norm=norm, check_ids=check_ids)
        ctx.save_for_backward(ent, rel, idx, loss, d_pos, d_neg)
        ctx.norm, ctx.check_ids = norm, check_ids
        return loss

    @staticmethod
    def backward(ctx, g):
        ent, rel, idx, loss, d_pos, d_neg = ctx.saved_tensors
        d_ent, d_rel = ts.transe_score_bwd(
            ent, rel, idx, g.float().contiguous(), loss, d_pos, d_neg,
            norm=ctx.norm, check_ids=ctx.check_ids)
        return d_ent, d_rel, None, None, None, None


def fused_pair_loss(ent, rel, idx, margin: float, norm: str,
                    check_ids: bool = True) -> torch.Tensor:
    """Differentiable per-pair hinge ``idx.shape[:-1]`` through the
    kernels.  ``check_ids=False`` drops the kernels' id range checks and
    their host syncs (``kernels/transe_score.py``)."""
    return _FusedPairLoss.apply(ent, rel, idx, margin, norm, check_ids)


def fused_margin_loss(ent, rel, idx, margin: float, norm: str
                      ) -> torch.Tensor:
    """Mean hinge over the batch axis (the reference's
    ``fused_margin_loss``), differentiable through the kernels."""
    return fused_pair_loss(ent, rel, idx, margin, norm).mean(-1)


def transe_pair_loss(params: Params, pos, neg, *, margin: float = 1.0,
                     norm: str = "l1", check_ids: bool = True
                     ) -> torch.Tensor:
    """Fused replacement for TransE's ``per_pair_loss``."""
    return fused_pair_loss(params["ent"], params["rel"], _pack_idx(pos, neg),
                           margin, norm, check_ids)


def transe_margin_loss(params: Params, pos, neg, *, margin: float = 1.0,
                       norm: str = "l1") -> torch.Tensor:
    """Fused replacement for TransE's ``margin_loss``."""
    return fused_margin_loss(params["ent"], params["rel"],
                             _pack_idx(pos, neg), margin, norm)


def kg_pair_loss(model, params: Params, pos, neg, *, margin: float = 1.0,
                 norm: str = "l1", check_ids: bool = True) -> torch.Tensor:
    """Model-dispatched per-pair hinge, differentiable: fused models take
    their kernels (``fused_pair_loss``; ``check_ids=False`` drops the
    kernels' id range checks and host syncs), others their plain
    ``per_pair_loss``."""
    model = get_model(model)
    if model.supports_fused_kernel:
        return model.fused_pair_loss(params, pos, neg, margin=margin,
                                     norm=norm, check_ids=check_ids)
    return model.per_pair_loss(params, pos, neg, margin=margin, norm=norm)


def kg_margin_loss(model, params: Params, pos, neg, *, margin: float = 1.0,
                   norm: str = "l1") -> torch.Tensor:
    """Model-dispatched mean margin loss (``fused_margin_loss`` or
    ``margin_loss``), differentiable."""
    model = get_model(model)
    if model.supports_fused_kernel:
        return model.fused_margin_loss(params, pos, neg, margin=margin,
                                       norm=norm)
    return model.margin_loss(params, pos, neg, margin=margin, norm=norm)


# ---------------------------------------------------------------------------
# Entity-inference ranking (evaluation path)
# ---------------------------------------------------------------------------


def fused_eval_available(model, params: Params) -> bool:
    """True when entity ranking for ``model`` should go through its rank
    kernel: the model declares ``supports_fused_kernel`` AND its tables
    are CUDA tensors.  The device eval engine's ``fused=None`` auto mode
    keys off this."""
    model = get_model(model)
    return model.supports_fused_kernel and params["ent"].is_cuda


def entity_rank_counts(
    params: Params,
    triplets,                  # (B, 3)
    side: str = "tail",
    *,
    norm: str = "l1",
    model="transe",
):
    """rank-1 counts (entities strictly closer than gold) per triplet:
    rank = 1 + returned count.  Fused-kernel models go through their rank
    kernel (``fused_rank_counts``); others count over their candidate
    score matrix, reading the gold score out of the SAME matrix (a
    recompute could differ in the last ulp and make the gold count
    itself)."""
    model = get_model(model)
    if model.supports_fused_kernel:
        return model.fused_rank_counts(params, triplets, side, norm=norm)
    trip = triplets.long()
    scores = model.candidate_energies(params, trip, side, norm)
    gold = trip[:, 2] if side == "tail" else trip[:, 0]
    gold_d = scores.gather(1, gold[:, None])
    return (scores < gold_d).sum(dim=1).int()
