"""The model-agnostic KG embedding interface (port of
``repro.core.models.base``), inference half.

A scoring model provides ``init_params`` (a dict of ``(N, k)`` tables),
``energy`` (d(h, r, t) for a batch of triplets, lower = truer),
``normalize`` (the constraint projection), ``param_roles`` and the batched
eval scorers ``candidate_energies`` / ``relation_energies``.  Training
methods (margin loss, SGD steps, epochs) come with the training slice.

Params are a plain dict ``{table_name: (N, k) tensor}``; triplets are
integer ``(..., 3)`` tensors of ``(h, r, t)`` ids on the tables' device.

Distances sum over the embedding axis in index order, ``j = 0 .. k-1``,
one elementwise op at a time (:func:`seq_distance`).  That is the order
the CUDA rank kernel sums in, so the kernel, the plain version and these
scorers agree bitwise on the card, and a scorer never holds a
``(B, E, k)`` difference tensor.  The reference lets XLA pick the order;
the two packages therefore agree to a few ulps, not bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class KGConfig:
    """Sizes of a scoring model's tables (the training hyper-parameters of
    the reference's config come with the training slice)."""

    n_entities: int
    n_relations: int
    dim: int = 50
    dtype: torch.dtype = torch.float32


def _check_norm(norm: str) -> None:
    if norm not in ("l1", "l2"):
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")


def _seq_sum(term: Callable[[int], torch.Tensor], k: int,
             norm: str) -> torch.Tensor:
    """``Σ_j term(j)`` in index order, then the L2 root when ``norm`` asks
    for it."""
    acc = term(0)
    for j in range(1, k):
        acc = acc + term(j)
    return acc if norm == "l1" else torch.sqrt(acc + 1e-12)


def seq_distance(
    part: Callable[[int], torch.Tensor], k: int, norm: str
) -> torch.Tensor:
    """L1 ``Σ_j |x_j|`` or L2 ``sqrt(Σ_j x_j² + 1e-12)`` of the vectors
    whose ``j``-th components ``part(j)`` returns, summed in index order
    ``j = 0 .. k-1`` with one rounding per operation (no fused
    multiply-add)."""
    _check_norm(norm)
    if norm == "l1":
        return _seq_sum(lambda j: part(j).abs(), k, norm)

    def square(j):
        x = part(j)
        return x * x

    return _seq_sum(square, k, norm)


def dissimilarity(x: torch.Tensor, norm: str) -> torch.Tensor:
    """L1 / L2 norm over the last axis, summed in index order — the same
    operations as :func:`seq_distance`, with the elementwise ``|x|`` or
    ``x²`` taken in one pass over ``x``."""
    _check_norm(norm)
    terms = x.abs() if norm == "l1" else x * x
    return _seq_sum(lambda j: terms[..., j], x.shape[-1], norm)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization (the constraint projection primitive)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def uniform_table(
    generator: torch.Generator, n: int, dim: int, dtype, device
) -> torch.Tensor:
    """Uniform(-6/sqrt(k), 6/sqrt(k)) init (TransE Algorithm 1, lines 1-4),
    drawn on the CPU from ``generator`` and then moved to ``device``, so a
    seed gives the same table on every device."""
    bound = 6.0 / dim ** 0.5
    u = torch.rand((n, dim), generator=generator, dtype=torch.float32)
    return (u * (2 * bound) - bound).to(device=device, dtype=dtype)


def _long(triplets) -> torch.Tensor:
    return torch.as_tensor(triplets).long()


class KGModel:
    """Base class: subclass, fill in the model-specific pieces, register."""

    name: str = "base"
    # table name -> which touch-stats table governs its merge ('ent' | 'rel')
    roles: Dict[str, str] = {"ent": "ent", "rel": "rel"}
    # True iff kernels/ops.py has a fused rank-count kernel for this model
    supports_fused_kernel: bool = False

    # -- model-specific interface ------------------------------------------

    def init_params(self, generator: torch.Generator, cfg: KGConfig,
                    device=None) -> Params:
        raise NotImplementedError

    def energy(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """d(h, r, t) for a batch of triplets ``(..., 3)`` -> ``(...,)``.
        Lower = more plausible."""
        raise NotImplementedError

    def normalize(self, params: Params) -> Params:
        """Constraint projection (default: unit-L2 entity rows)."""
        out = dict(params)
        out["ent"] = unit_rows(params["ent"])
        return out

    def param_roles(self) -> Dict[str, str]:
        return dict(self.roles)

    # -- eval scoring (generic fallbacks; override with closed forms) ------

    def candidate_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1"
    ) -> torch.Tensor:
        """Energies of every entity substituted as ``side`` ('tail'|'head')
        of each triplet: ``(B, 3) -> (B, E)``.  The generic fallback scores
        all ``B·E`` substituted triplets; models override."""
        if side not in ("tail", "head"):
            raise ValueError(f"bad side {side!r}")
        col = 2 if side == "tail" else 0
        trip = _long(triplets)
        E = params["ent"].shape[0]
        subst = trip[:, None, :].repeat(1, E, 1)
        subst[:, :, col] = torch.arange(E, device=trip.device)
        return self.energy(params, subst, norm)

    def relation_energies(
        self, params: Params, triplets: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Energies of every relation substituted into each triplet:
        ``(B, 3) -> (B, R)``."""
        trip = _long(triplets)
        R = params["rel"].shape[0]
        subst = trip[:, None, :].repeat(1, R, 1)
        subst[:, :, 1] = torch.arange(R, device=trip.device)
        return self.energy(params, subst, norm)

    # -- fused-kernel hook (kernels/ops.py dispatch) -------------------------

    def fused_rank_counts(
        self, params: Params, triplets: torch.Tensor, side: str, *,
        norm: str
    ) -> torch.Tensor:
        """Entity-inference rank counts through the model's rank kernel.  A
        model declaring ``supports_fused_kernel = True`` MUST override
        this: the dispatch in kernels/ops.py calls it blindly."""
        raise NotImplementedError(
            f"{self.name!r} sets supports_fused_kernel but does not "
            "implement fused_rank_counts")
