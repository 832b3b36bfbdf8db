"""TransE (Bordes et al., 2013), the scoring model the paper parallelizes
(port of ``repro.core.models.transe``).

A true triplet ``<h, r, t>`` should satisfy ``h + r ≈ t``; its energy
(Eq. 1 of the paper) is ``d(h, r, t) = || h + r - t ||_{1 or 2}``.

The closed-form scorers build the per-query vector once (``q = h + r`` for
the tail side, ``t - r`` for the head side) and sweep the entity table one
embedding column at a time (``base.seq_distance``), so a ``(B, E)`` score
matrix never passes through a ``(B, E, k)`` tensor.  ``fused_rank_counts``
hands the sweep to the CUDA rank kernel (``kernels/rank_topk.py``).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.models import base
from repro_torch.core.models.base import (
    KGConfig, Params, _long, dissimilarity, seq_distance)


class TransE(base.KGModel):
    name = "transe"
    roles = {"ent": "ent", "rel": "rel"}
    supports_fused_kernel = True

    def init_params(self, generator: torch.Generator, cfg: KGConfig,
                    device=None) -> Params:
        """Uniform(-6/sqrt(k), 6/sqrt(k)) init; relations L2-normalized once
        (TransE Algorithm 1, lines 1-4).  Draws entities then relations
        from ``generator`` (a CPU ``torch.Generator``)."""
        device = resolve_device(device)
        ent = base.uniform_table(
            generator, cfg.n_entities, cfg.dim, cfg.dtype, device)
        rel = base.uniform_table(
            generator, cfg.n_relations, cfg.dim, cfg.dtype, device)
        rel = rel / (torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
                     + 1e-12)
        return {"ent": ent, "rel": rel}

    def energy(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        trip = _long(triplets)
        h = params["ent"][trip[..., 0]]
        r = params["rel"][trip[..., 1]]
        t = params["ent"][trip[..., 2]]
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
        q, _ = self._query(params, _long(triplets), side)
        cols = params["ent"].t()                           # (k, E) view
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
