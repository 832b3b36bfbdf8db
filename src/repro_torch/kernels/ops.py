"""Model-aware dispatch onto the port's kernels (port of the evaluation
half of ``repro.kernels.ops``).

Models with a fused path (``supports_fused_kernel``, currently TransE)
rank through the CUDA rank kernel; every other model scores candidates
with its plain PyTorch ``candidate_energies``.
"""
from __future__ import annotations

from repro_torch.core.models import Params, get_model


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
