"""DistMult (Yang et al., 2015), the canonical non-translational model
(port of ``repro.core.models.distmult``).

Bilinear-diagonal score ``s(h, r, t) = Σ_i h_i r_i t_i`` (higher = truer);
the engine minimizes energies, so the energy is the negated score.
``norm`` means nothing for a bilinear score and is ignored.

The reference's matrix products become sums over the embedding axis in
index order, one rounding per operation: each output element is then
computed alone, so a slice of the candidate matrix is its columns
bitwise (the reference's XLA matmul over a slice is not the slice of the
matmul), a served answer is the same at any batch size, and a CPU run
sums as a card run does.  Each form keeps the reference's product order,
because the orders round differently: ``energy`` is ``-Σ (h·r)·t``,
``candidate_energies`` ``-Σ (fixed·r)_j · e_j`` (``fixed`` the head for
the tail side, the tail for the head side), ``relation_energies``
``-Σ (h·t)_j · r_j``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.models import base
from repro_torch.core.models.base import (
    KGConfig, Params, _long, gather_rows, in_order_dot, seq_total, wide)


class DistMult(base.KGModel):
    name = "distmult"
    roles = {"ent": "ent", "rel": "rel"}

    def init_params(self, generator: torch.Generator, cfg: KGConfig,
                    device=None) -> Params:
        """Uniform(-6/sqrt(k), 6/sqrt(k)) tables drawn from ``generator``
        (a CPU ``torch.Generator``), entities then relations."""
        device = resolve_device(device)
        ent = base.uniform_table(
            generator, cfg.n_entities, cfg.dim, cfg.dtype, device)
        rel = base.uniform_table(
            generator, cfg.n_relations, cfg.dim, cfg.dtype, device)
        return {"ent": ent, "rel": rel}

    def energy(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        trip = _long(triplets)
        h = gather_rows(params["ent"], trip[..., 0])
        r = gather_rows(params["rel"], trip[..., 1])
        t = gather_rows(params["ent"], trip[..., 2])
        return -in_order_dot(h * r, t)

    def candidate_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form ``-Σ_j (fixed·r)_j e_j`` for every entity ``e``,
        ``(B, E)``: the score is symmetric in h and t, so both sides share
        it."""
        return self._candidates(params, triplets, params["ent"], side)

    def candidate_slice_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1", *, lo: int, n: int
    ) -> torch.Tensor:
        """The same sums against entity rows ``[lo, lo + n)`` only: each
        column is that of :meth:`candidate_energies` bitwise."""
        return self._candidates(params, triplets, params["ent"][lo:lo + n],
                                side)

    def _candidates(self, params: Params, triplets, cent: torch.Tensor,
                    side: str) -> torch.Tensor:
        trip = _long(triplets)
        if side == "tail":
            fixed = params["ent"][trip[:, 0]]
        elif side == "head":
            fixed = params["ent"][trip[:, 2]]
        else:
            raise ValueError(f"bad side {side!r}")
        fr = wide(fixed * params["rel"][trip[:, 1]])       # (B, k)
        cols = wide(cent.t())                              # (k, n) view
        return -seq_total(lambda j: fr[:, j, None] * cols[j][None, :],
                          fr.shape[1], cent.dtype)

    def relation_energies(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form ``-Σ_j (h·t)_j r_j`` for every relation, ``(B, R)``."""
        trip = _long(triplets)
        ent = params["ent"]
        ht = wide(ent[trip[:, 0]] * ent[trip[:, 2]])
        cols = wide(params["rel"].t())                     # (k, R) view
        return -seq_total(lambda j: ht[:, j, None] * cols[j][None, :],
                          ht.shape[1], ent.dtype)

    def joint_energies(
        self, params: Params, pos: torch.Tensor, cand: torch.Tensor,
        side_head: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form ``-Σ_j q_j c_j``, ``(…, B, C)``, with the per-row
        query ``q = r·t`` (head side) or ``h·r`` (tail side)."""
        ent, rel = params["ent"], params["rel"]
        pos = _long(pos)
        h, r, t = pos[..., 0], pos[..., 1], pos[..., 2]
        q = torch.where(
            side_head[..., None],
            gather_rows(rel, r) * gather_rows(ent, t),
            gather_rows(ent, h) * gather_rows(rel, r))     # (…, B, k)
        cm = gather_rows(ent, _long(cand))                 # (…, C, k)
        return -in_order_dot(q[..., :, None, :], cm[..., None, :, :])
