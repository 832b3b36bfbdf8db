"""TransH (Wang et al., 2014), translation on relation-specific hyperplanes
(port of ``repro.core.models.transh``).

Each relation has a translation vector ``d_r`` and a hyperplane normal
``w_r``; entities are projected onto the hyperplane before translating:

    d(h, r, t) = || (h - w_r^T h w_r) + d_r - (t - w_r^T t w_r) ||_{1 or 2}

The normal table ``"norm"`` is relation-indexed (``roles``), so the Reduce
merges it with the relation touch stats, the device pipeline draws its
``random`` priorities over relation rows, and checkpoints carry it as a
third table: no engine change.

Every dot product over the embedding axis is summed in index order, one
rounding per operation, as TransE's distances are (``base.in_order_sum``
on a materialized product, ``base.seq_total`` one column at a time where
the candidates are the whole entity table).  The reference's ``einsum``
becomes such a sum, so a slice of the candidate matrix is its columns
bitwise and a CPU run sums as a card run does.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.models import base
from repro_torch.core.models.base import (
    KGConfig, Params, _long, dissimilarity, gather_rows, in_order_dot,
    seq_distance, seq_total, spread_last, unit_rows, wide)


def _project(x: torch.Tensor, w_unit: torch.Tensor) -> torch.Tensor:
    """``x`` minus its component along the (unit) hyperplane normal."""
    return x - spread_last(in_order_dot(x, w_unit), x.shape[-1]) * w_unit


class TransH(base.KGModel):
    name = "transh"
    roles = {"ent": "ent", "rel": "rel", "norm": "rel"}

    def init_params(self, generator: torch.Generator, cfg: KGConfig,
                    device=None) -> Params:
        """Uniform(-6/sqrt(k), 6/sqrt(k)) tables drawn from ``generator``
        (a CPU ``torch.Generator``) in the order entities, relations,
        normals; relation and normal rows unit-L2."""
        device = resolve_device(device)
        table = lambda n: base.uniform_table(generator, n, cfg.dim,
                                             cfg.dtype, device)
        ent = table(cfg.n_entities)
        rel = unit_rows(table(cfg.n_relations))
        w = unit_rows(table(cfg.n_relations))
        return {"ent": ent, "rel": rel, "norm": w}

    def energy(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        trip = _long(triplets)
        h = gather_rows(params["ent"], trip[..., 0])
        r = gather_rows(params["rel"], trip[..., 1])
        t = gather_rows(params["ent"], trip[..., 2])
        # re-unitized inside the energy, so the score is defined between
        # constraint projections; the gradient flows through unit_rows
        w = unit_rows(gather_rows(params["norm"], trip[..., 1]))
        return dissimilarity(_project(h, w) + r - _project(t, w), norm)

    def normalize(self, params: Params) -> Params:
        """Unit entities and unit hyperplane normals (TransH constraints)."""
        out = dict(params)
        out["ent"] = unit_rows(params["ent"])
        out["norm"] = unit_rows(params["norm"])
        return out

    def normalize_rows(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """Row-local :meth:`normalize`: unit rows for the entity and the
        hyperplane-normal tables."""
        if name in ("ent", "norm"):
            return unit_rows(rows)
        return rows

    def candidate_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form: every entity projected onto each triplet's
        hyperplane, ``(B, E)``, one embedding column at a time (no
        ``(B, E, k)`` tensor)."""
        return self._candidates(params, triplets, params["ent"], side, norm)

    def candidate_slice_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1", *, lo: int, n: int
    ) -> torch.Tensor:
        """Shard-local scan over entity rows ``[lo, lo + n)``: the
        projection is elementwise in the candidate row, so each column is
        that of :meth:`candidate_energies` bitwise."""
        return self._candidates(params, triplets,
                                params["ent"][lo:lo + n], side, norm)

    def _candidates(self, params: Params, triplets, cent: torch.Tensor,
                    side: str, norm: str) -> torch.Tensor:
        """``(B, n)`` energies of the candidate rows ``cent`` ``(n, k)``:
        ``dot[b, e] = Σ_j e_j w_j``, the projection ``e_j - dot · w_j``, and
        the tail side's ``(h⊥ + d_r) - e⊥`` or the head side's
        ``e⊥ + (d_r - t⊥)``, as the reference orders them."""
        if side not in ("tail", "head"):
            raise ValueError(f"bad side {side!r}")
        trip = _long(triplets)
        ent = params["ent"]
        r = params["rel"][trip[:, 1]]                      # (B, k)
        w = unit_rows(params["norm"][trip[:, 1]])          # (B, k)
        cols = cent.t()                                    # (k, n) view
        k = cent.shape[1]
        wc, ww = wide(cols), wide(w)
        dot = seq_total(lambda j: wc[j][None, :] * ww[:, j, None], k,
                        cent.dtype)
        proj = lambda j: cols[j][None, :] - dot * w[:, j, None]
        if side == "tail":
            q = _project(ent[trip[:, 0]], w) + r
            part = lambda j: q[:, j, None] - proj(j)
        else:
            q = r - _project(ent[trip[:, 2]], w)
            part = lambda j: proj(j) + q[:, j, None]
        return seq_distance(part, k, norm)

    def joint_energies(
        self, params: Params, pos: torch.Tensor, cand: torch.Tensor,
        side_head: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Closed form, ``(…, B, C)``: the C candidates projected onto every
        positive's hyperplane in one ``(…, B, C, k)`` broadcast.  Norms are
        sign-invariant, so both sides are ``||c⊥ - q||`` with ``q = t⊥ -
        d_r`` (head side) or ``h⊥ + d_r`` (tail side)."""
        ent = params["ent"]
        pos = _long(pos)
        r = gather_rows(params["rel"], pos[..., 1])        # (…, B, k)
        w = unit_rows(gather_rows(params["norm"], pos[..., 1]))
        ce = gather_rows(ent, _long(cand))[..., None, :, :]  # (…, 1, C, k)
        wb = w[..., :, None, :]                            # (…, B, 1, k)
        c_proj = ce - in_order_dot(wb, ce)[..., None] * wb
        hp = _project(gather_rows(ent, pos[..., 0]), w)
        tp = _project(gather_rows(ent, pos[..., 2]), w)
        q = torch.where(side_head[..., None], tp - r, hp + r)
        return dissimilarity(c_proj - q[..., :, None, :], norm)
