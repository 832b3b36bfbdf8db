"""TransE (Bordes et al., 2013), the scoring model the paper parallelizes
(port of ``repro.core.models.transe``).

A true triplet ``<h, r, t>`` should satisfy ``h + r ≈ t``; its energy
(Eq. 1 of the paper) is ``d(h, r, t) = || h + r - t ||_{1 or 2}``.

The closed-form scorers build the per-query vector once (``q = h + r`` for
the tail side, ``t - r`` for the head side) and sweep the entity table one
embedding column at a time (``base.seq_distance``), so a ``(B, E)`` score
matrix never passes through a ``(B, E, k)`` tensor.  ``fused_rank_counts``
hands the sweep to the CUDA rank kernel (``kernels/rank_topk.py``), and
``fused_pair_loss`` / ``fused_margin_loss`` the per-triplet training
step to the ``transe_score`` kernels (``kernels/transe_score.py``).  The
joint objective's ``joint_energies`` is plain PyTorch, as the reference's
is plain jnp.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.models import base
from repro_torch.core.models.base import (
    KGConfig, Params, _long, dissimilarity, gather_rows, seq_distance)
from repro_torch.util import sqrt_rn


class TransE(base.KGModel):
    name = "transe"
    roles = {"ent": "ent", "rel": "rel"}
    supports_fused_kernel = True

    def init_params(self, generator: torch.Generator, cfg: KGConfig,
                    device=None) -> Params:
        """Uniform(-6/sqrt(k), 6/sqrt(k)) init; relations L2-normalized once
        (TransE Algorithm 1, lines 1-4).  Draws entities then relations
        from ``generator`` (a CPU ``torch.Generator``); the same bits on
        every device."""
        device = resolve_device(device)
        ent = base.uniform_table(
            generator, cfg.n_entities, cfg.dim, cfg.dtype, device)
        rel = base.uniform_table(
            generator, cfg.n_relations, cfg.dim, cfg.dtype, device)
        return {"ent": ent, "rel": base.unit_rows(rel)}

    def energy(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        trip = _long(triplets)
        h = gather_rows(params["ent"], trip[..., 0])
        r = gather_rows(params["rel"], trip[..., 1])
        t = gather_rows(params["ent"], trip[..., 2])
        return dissimilarity(h + r - t, norm)

    def _query(self, params: Params, trip: torch.Tensor, side: str):
        """(query vector, gold entity ids) of each triplet for ``side``."""
        ent, rel = params["ent"], params["rel"]
        if side == "tail":
            return ent[trip[:, 0]] + rel[trip[:, 1]], trip[:, 2]
        if side == "head":
            return ent[trip[:, 2]] - rel[trip[:, 1]], trip[:, 0]
        raise ValueError(f"bad side {side!r}")

    def candidate_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form: ``||q - e||`` for every entity ``e``, ``(B, E)``."""
        return self._candidates(params, triplets, params["ent"], side, norm)

    def candidate_slice_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1", *, lo: int, n: int
    ) -> torch.Tensor:
        """Shard-local scan over entity rows ``[lo, lo + n)`` only: each
        column is computed by the same elementwise operations and in-order
        sum as in :meth:`candidate_energies`, so it is that column
        bitwise."""
        return self._candidates(params, triplets,
                                params["ent"][lo:lo + n], side, norm)

    def _candidates(self, params: Params, triplets, cent: torch.Tensor,
                    side: str, norm: str) -> torch.Tensor:
        """``(B, n)`` energies of the candidate rows ``cent`` ``(n, k)``."""
        q, _ = self._query(params, _long(triplets), side)
        cols = cent.t()                                    # (k, n) view
        if side == "tail":
            part = lambda j: q[:, j, None] - cols[j][None, :]
        else:
            part = lambda j: cols[j][None, :] - q[:, j, None]
        return seq_distance(part, q.shape[1], norm)

    def relation_energies(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form: ``||(h - t) + r||`` for every relation, ``(B, R)``."""
        trip = _long(triplets)
        ent = params["ent"]
        hmt = ent[trip[:, 0]] - ent[trip[:, 2]]
        cols = params["rel"].t()                           # (k, R) view
        return seq_distance(
            lambda j: hmt[:, j, None] + cols[j][None, :], hmt.shape[1], norm)

    def joint_energies(
        self, params: Params, pos: torch.Tensor, cand: torch.Tensor,
        side_head: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form, ``(…, B, C)``: a corrupted head scores
        ``||c + r - t||`` and a corrupted tail ``||h + r - c||``; both norms
        are sign-invariant, so each is ``||c - q||`` with the per-row query
        ``q = t - r`` (head side) or ``h + r`` (tail side), and the pool is
        gathered C times instead of B·C.  Under L2 the reference's
        expansion ``sqrt(max(|q|² - 2 q·c + |c|², 0) + 1e-12)``, every
        product summed in index order (no matrix product); under L1 the
        ``(…, B, C, k)`` difference.  Plain ops, differentiable: no
        ``transe_score`` kernel lies on the joint objective."""
        ent, rel = params["ent"], params["rel"]
        pos = _long(pos)
        h, r, t = pos[..., 0], pos[..., 1], pos[..., 2]
        q = torch.where(
            side_head[..., None],
            gather_rows(ent, t) - gather_rows(rel, r),
            gather_rows(ent, h) + gather_rows(rel, r))     # (…, B, k)
        cm = gather_rows(ent, _long(cand))                 # (…, C, k)
        if norm == "l2":
            qc = base.in_order_sum(q[..., :, None, :] * cm[..., None, :, :])
            d2 = ((base.in_order_sum(q * q)[..., None] - 2.0 * qc)
                  + base.in_order_sum(cm * cm)[..., None, :])
            return sqrt_rn(torch.clamp_min(d2, 0.0) + 1e-12)
        return dissimilarity(cm[..., None, :, :] - q[..., :, None, :], norm)

    # -- fused kernels (late imports: kernels/ops imports this package) -----

    def fused_pair_loss(self, params: Params, pos, neg, *, margin: float,
                        norm: str, check_ids: bool = True) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.transe_pair_loss(params, pos, neg, margin=margin,
                                    norm=norm, check_ids=check_ids)

    def fused_margin_loss(self, params: Params, pos, neg, *, margin: float,
                          norm: str) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.transe_margin_loss(params, pos, neg, margin=margin,
                                      norm=norm)

    def fused_rank_counts(
        self, params: Params, triplets: torch.Tensor, side: str, *,
        norm: str
    ) -> torch.Tensor:
        """Rank counts through the rank kernel: ``q = h + r`` (tail) or
        ``t - r`` (head), count entities strictly closer than the gold.
        ``gold_d`` is taken in fp32 and summed in the kernel's order, so
        under L1 the kernel's distance to the gold entity equals it bitwise
        and the gold never counts itself; under L2 the kernel's expanded
        form may differ from this direct form by an ulp, as in the
        reference."""
        from repro_torch.kernels import rank_topk

        q, gold = self._query(params, _long(triplets), side)
        gold_d = dissimilarity(q.float() - params["ent"][gold].float(), norm)
        return rank_topk.rank_counts(q, params["ent"], gold_d, norm=norm)
