"""The model-agnostic KG embedding interface (port of
``repro.core.models.base``).

A scoring model provides ``init_params`` (a dict of ``(N, k)`` tables),
``energy`` (d(h, r, t) for a batch of triplets, lower = truer),
``normalize`` (the constraint projection), ``param_roles`` and the batched
eval scorers ``candidate_energies`` / ``relation_energies``.  The engine
math shared by every model — margin loss, SGD steps, local epochs with the
Reduce's touch stats, BGD gradients — is implemented once here.

Params are a plain dict ``{table_name: (N, k) tensor}``; triplets are
integer ``(..., 3)`` tensors of ``(h, r, t)`` ids on the tables' device.
Where the reference vmaps over workers, the port writes the worker axis
out: stacked ``(W, N, k)`` tables with ``(W, B, 3)`` batches of each
worker's own ids, so one kernel launch serves all W workers of a step.

Distances sum over the embedding axis in index order, ``j = 0 .. k-1``,
one elementwise op at a time (:func:`seq_distance`).  That is the order
the CUDA kernels sum in, so kernels, plain versions and these scorers
agree bitwise on the card, and a scorer never holds a ``(B, E, k)``
difference tensor.  The reference lets XLA pick the order; the two
packages therefore agree to a few ulps, not bitwise.

Gradients: a model declaring ``supports_fused_kernel`` (TransE) trains
through ``kernels/ops.kg_pair_loss``, whose backward is the closed form of
the ``transe_score_bwd`` kernel; the reference takes ``jax.grad`` of
``margin_loss``.  The two agree at rtol 1e-4, atol 1e-5
(``tests/test_torch_kernels_transe_score.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import negative
from repro_torch.util import (
    exact_div, not_ported, ordered_index_add, sqrt_rn, worker_offsets)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class KGConfig:
    """Hyper-parameters shared by every registered scoring model
    (single-thread training is paper Algorithm 1 with the model's energy)."""

    n_entities: int
    n_relations: int
    dim: int = 50
    margin: float = 1.0
    norm: str = "l1"            # 'l1' | 'l2'  (Eq. 1 allows either)
    learning_rate: float = 0.01
    # 'epoch' applies the model's constraint projection at the start of each
    # epoch (TransE); 'step' after every SGD step; 'none' disables.
    normalize: str = "epoch"
    # negative sampling: 'unif' (paper / TransE) or 'bern' (TransH-style)
    sampling: str = "unif"
    # negative scoring: 'pertriplet' pairs each positive with its one
    # corrupted counterpart (Eq. 3, the paper); 'joint' (DGL-KE's shared
    # candidate pool) is not ported yet
    negatives: str = "pertriplet"
    neg_candidates: int = 0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.norm not in ("l1", "l2"):
            raise ValueError(f"norm must be 'l1' or 'l2', got {self.norm!r}")
        if self.normalize not in ("epoch", "step", "none"):
            raise ValueError(f"bad normalize: {self.normalize!r}")
        if self.negatives not in ("pertriplet", "joint"):
            raise ValueError(f"bad negatives: {self.negatives!r}")
        if self.neg_candidates < 0:
            raise ValueError(
                f"neg_candidates must be >= 0 (0 = full batch), got "
                f"{self.neg_candidates}")
        if self.negatives == "joint":
            raise not_ported("negatives='joint'", 10)


def _check_norm(norm: str) -> None:
    if norm not in ("l1", "l2"):
        raise ValueError(f"norm must be 'l1' or 'l2', got {norm!r}")


_HALF = (torch.bfloat16, torch.float16)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` widened to float32 when it is half precision (its ``|x|`` and
    ``x²`` are then exact), else ``x`` itself."""
    return x.float() if x.dtype in _HALF else x


def _seq_sum(term: Callable[[int], torch.Tensor], k: int) -> torch.Tensor:
    """``Σ_j term(j)`` in index order, one rounding per addition."""
    acc = term(0)
    for j in range(1, k):
        acc = acc + term(j)
    return acc


def _finish(total: torch.Tensor, dtype, norm: str) -> torch.Tensor:
    """A distance's sum rounded once to its inputs' ``dtype``, then the L2
    root when ``norm`` asks for it.  Half-precision inputs are summed in
    float32 from exact terms (:func:`_wide`), as the reference's
    ``jnp.sum`` of bf16 is: a bf16 sum rounded at every addition would
    move energies by an ulp and reorder top-k answers."""
    total = total.to(dtype)
    return total if norm == "l1" else sqrt_rn(total + 1e-12)


def seq_distance(
    part: Callable[[int], torch.Tensor], k: int, norm: str
) -> torch.Tensor:
    """L1 ``Σ_j |x_j|`` or L2 ``sqrt(Σ_j x_j² + 1e-12)`` of the vectors
    whose ``j``-th components ``part(j)`` returns, summed in index order
    ``j = 0 .. k-1`` with one rounding per operation (no fused
    multiply-add; half precision as in :func:`_finish`)."""
    _check_norm(norm)
    first = part(0)

    def term(j):
        x = _wide(first if j == 0 else part(j))
        return x.abs() if norm == "l1" else x * x

    return _finish(_seq_sum(term, k), first.dtype, norm)


def dissimilarity(x: torch.Tensor, norm: str) -> torch.Tensor:
    """L1 / L2 norm over the last axis, summed in index order — the same
    operations as :func:`seq_distance`, with the elementwise ``|x|`` or
    ``x²`` taken in one pass over ``x``."""
    _check_norm(norm)
    w = _wide(x)
    terms = w.abs() if norm == "l1" else w * w
    return _finish(_seq_sum(lambda j: terms[..., j], x.shape[-1]),
                   x.dtype, norm)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization (the constraint projection primitive),
    ``x / (sqrt(Σ_j x_j²) + 1e-12)`` with the squares summed in index
    order, so a projection gives the same bits on the CPU and the card."""
    w = _wide(x)
    sq = w * w
    norm = sqrt_rn(_seq_sum(lambda j: sq[..., j], x.shape[-1]).to(x.dtype))
    return x / (norm[..., None] + 1e-12)


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


def pairwise_hinge(
    d_pos: torch.Tensor, d_neg: torch.Tensor, margin: float
) -> torch.Tensor:
    """[gamma + d(pos) - d(neg)]_+  (Eq. 3 summand), as
    ``max((margin + d_pos) - d_neg, 0)``."""
    return torch.clamp_min((margin + d_pos) - d_neg, 0.0)


def apply_gradients(params: Params, grads: Params, lr: float) -> Params:
    """``p - lr * g`` for every table (two roundings, no fused
    multiply-add)."""
    return {name: p - lr * grads[name] for name, p in params.items()}


@dataclasses.dataclass(frozen=True)
class EpochStats:
    """Bookkeeping one Map worker emits for the Reduce phase (with a
    leading worker axis when the epoch ran stacked workers)."""

    mean_loss: torch.Tensor     # scalar, mean pair loss over the epoch
    ent_count: torch.Tensor     # (E,) how many updates touched each entity
    # (E,) summed pair loss attributed to entity; None when the epoch was
    # run without touch losses (only miniloss_perkey reads them)
    ent_loss: Optional[torch.Tensor]
    rel_count: torch.Tensor     # (R,)
    rel_loss: Optional[torch.Tensor]  # (R,)


def _flatten_workers(params: Params, pos, neg):
    """Stacked ``(W, N, k)`` tables as ``(W·N, k)`` and ``(W, B, 3)``
    batches with each worker's ids offset onto its rows, so a plain
    ``energy`` scores all workers at once; unstacked inputs pass through."""
    if params["ent"].dim() == 2:
        return params, pos, neg
    eo, ro = worker_offsets(pos, params["ent"].shape[1],
                            params["rel"].shape[1])
    off = torch.stack([eo, ro, eo], dim=-1)               # (W, 1, 3)
    flat = {name: t.reshape(-1, t.shape[-1]) for name, t in params.items()}
    return flat, pos.long() + off, neg.long() + off


def _accumulate_touch(
    stats: tuple, pos: torch.Tensor, neg: torch.Tensor,
    pair_loss: torch.Tensor, E: int, R: int
) -> tuple:
    """Add one step's touches to ``(ent_count, ent_loss, rel_count,
    rel_loss)`` (flattened over workers for stacked batches): the keys an
    update touched are h, t of pos AND the corrupted entity of neg.

    The loss sums go through ``ordered_index_add`` in the reference's
    order (heads, then tails), so they are the same on every run — they
    pick ``miniloss_perkey``'s winners; ``None`` sums stay ``None``.  The
    counts are integers in fp32, exact in any order."""
    ent_count, ent_loss, rel_count, rel_loss = stats
    pos, neg = pos.long(), neg.long()
    eo, ro = worker_offsets(pos, E, R) if pos.dim() == 3 else (0, 0)
    heads = torch.cat([pos[..., 0] + eo, neg[..., 0] + eo], dim=-1)
    tails = torch.cat([pos[..., 2] + eo, neg[..., 2] + eo], dim=-1)
    rows = torch.cat([heads.reshape(-1), tails.reshape(-1)])
    rel_rows = (pos[..., 1] + ro).reshape(-1)
    ent_count = ent_count.index_add(
        0, rows, torch.ones_like(rows, dtype=ent_count.dtype))
    rel_count = rel_count.index_add(
        0, rel_rows, torch.ones_like(rel_rows, dtype=rel_count.dtype))
    if ent_loss is not None:
        l2 = torch.cat([pair_loss, pair_loss], dim=-1).reshape(-1)
        ent_loss = ordered_index_add(ent_loss, rows,
                                     torch.cat([l2, l2]).to(ent_loss.dtype))
        rel_loss = ordered_index_add(
            rel_loss, rel_rows, pair_loss.reshape(-1).to(rel_loss.dtype))
    return ent_count, ent_loss, rel_count, rel_loss


class KGModel:
    """Base class: subclass, fill in the model-specific pieces, register."""

    name: str = "base"
    # table name -> which touch-stats table governs its merge ('ent' | 'rel')
    roles: Dict[str, str] = {"ent": "ent", "rel": "rel"}
    # True iff kernels/ops.py has fused kernels for this model: the
    # transe_score forward/backward pair for its margin loss and the
    # rank_counts kernel for entity ranking
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

    # -- fused-kernel hooks (kernels/ops.py dispatch) ------------------------

    def fused_pair_loss(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor, *,
        margin: float, norm: str
    ) -> torch.Tensor:
        """Differentiable per-pair hinge through the model's kernels.  A
        model declaring ``supports_fused_kernel = True`` MUST override this
        and the two hooks below: the dispatch in kernels/ops.py calls them
        blindly."""
        raise NotImplementedError(
            f"{self.name!r} sets supports_fused_kernel but does not "
            "implement fused_pair_loss")

    def fused_margin_loss(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor, *,
        margin: float, norm: str
    ) -> torch.Tensor:
        """Mean margin loss through the model's kernels (see
        :meth:`fused_pair_loss`)."""
        raise NotImplementedError(
            f"{self.name!r} sets supports_fused_kernel but does not "
            "implement fused_margin_loss")

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

    # -- negative sampling --------------------------------------------------

    def make_negatives(
        self,
        pos_batches: torch.Tensor,
        cfg: KGConfig,
        head_prob_per_rel: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        uniform: Optional[torch.Tensor] = None,
        offset: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Corrupted counterparts of ``pos_batches`` (Eq. 2), draws from
        ``generator`` or passed in (``negative.make_negatives``).  Models
        with a bespoke corruption scheme override this."""
        return negative.make_negatives(
            pos_batches, cfg.n_entities, cfg.sampling, head_prob_per_rel,
            generator=generator, uniform=uniform, offset=offset)

    # -- shared engine math (identical for every model) ---------------------

    def margin_loss(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor, *,
        margin: float, norm: str
    ) -> torch.Tensor:
        """Mean margin ranking loss over the batch axis of (pos, neg)
        triplet pairs.  The paper sums over the training set; the mean
        keeps the learning rate batch-size independent."""
        return self.per_pair_loss(
            params, pos, neg, margin=margin, norm=norm).mean(-1)

    def per_pair_loss(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor, *,
        margin: float, norm: str
    ) -> torch.Tensor:
        """Hinge per (pos, neg) pair, ``pos.shape[:-1]``."""
        params, pos, neg = _flatten_workers(params, pos, neg)
        return pairwise_hinge(self.energy(params, pos, norm),
                              self.energy(params, neg, norm), margin)

    def _pair_loss_fn(self, cfg: KGConfig):
        """The training objective ``(params, pos, neg) -> (…, B)`` per-pair
        losses, differentiable: the model-dispatched loss of
        ``kernels/ops.kg_pair_loss`` (the kernels for fused models).  Its
        mean over the batch is the step's loss (the reference's
        ``_loss_fn``) and the pairs feed the touch stats, so a step scores
        each pair once."""
        from repro_torch.kernels import ops

        return functools.partial(ops.kg_pair_loss, self, margin=cfg.margin,
                                 norm=cfg.norm)

    def _pairs_and_grads(self, params: Params, pos, neg, cfg: KGConfig,
                         shared: bool = False):
        """``(pair losses, mean loss, grads)`` of one step: the objective on
        ``params`` and its gradient with respect to every table.

        With ``shared`` and a ``(W, B, 3)`` batch the tables are one set of
        ``(N, k)`` tables that all W workers read (BGD): they enter as a
        worker-stride-0 view ``(W, N, k)``, so each worker's gradient comes
        back in its own ``(N, k)`` slice."""
        if shared and pos.dim() == 3:
            W = pos.shape[0]
            leaves = {name: p.detach().expand(W, *p.shape).requires_grad_()
                      for name, p in params.items()}
        else:
            leaves = {name: p.detach().requires_grad_()
                      for name, p in params.items()}
        names = sorted(leaves)
        with torch.enable_grad():
            pair = self._pair_loss_fn(cfg)(leaves, pos, neg)
            loss = pair.mean(-1)
            grads = torch.autograd.grad(loss.sum(),
                                        [leaves[n] for n in names])
        return pair.detach(), loss.detach(), dict(zip(names, grads))

    def sgd_step(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor,
        cfg: KGConfig
    ) -> tuple:
        """One (mini-batch) SGD step of Algorithm 1's inner loop:
        ``(params, loss)``; stacked tables with a ``(W, B, 3)`` batch step
        every worker's own copy."""
        _, loss, grads = self._pairs_and_grads(params, pos, neg, cfg)
        params = apply_gradients(params, grads, cfg.learning_rate)
        if cfg.normalize == "step":
            params = self.normalize(params)
        return params, loss

    def run_epoch(
        self,
        params: Params,
        pos_batches: torch.Tensor,   # (S, B, 3), or (W, S, B, 3) stacked
        neg_batches: torch.Tensor,
        cfg: KGConfig,
        sparse_apply: bool = False,
        update_mask: Optional[Params] = None,
        touch_losses: bool = True,
    ) -> tuple:
        """One epoch of Algorithm 1: constraint projection, then SGD over
        the minibatches in order, tracking the per-key stats the Reduce
        needs.  With ``(W, N, k)`` tables and ``(W, S, B, 3)`` batches all W
        workers run side by side, each on its own copy; the stats then
        carry a leading worker axis.  ``touch_losses=False`` leaves the
        per-key loss sums out (``None``): only ``miniloss_perkey`` reads
        them, and they are the dearest part of the stats.  Returns
        ``(params, EpochStats)``."""
        if sparse_apply:
            raise not_ported("run_epoch(sparse_apply=True)", 11)
        if update_mask is not None:
            raise not_ported("run_epoch(update_mask=...)", 14)
        if cfg.normalize == "epoch":
            params = self.normalize(params)
        stacked = pos_batches.dim() == 4
        W = pos_batches.shape[0] if stacked else 1
        E, R = cfg.n_entities, cfg.n_relations
        dev = params["ent"].device
        zeros = lambda n: torch.zeros(W * n, dtype=cfg.dtype, device=dev)
        stats = (zeros(E), zeros(E) if touch_losses else None, zeros(R),
                 zeros(R) if touch_losses else None)
        loss_sum = torch.zeros((W,) if stacked else (), dtype=cfg.dtype,
                               device=dev)
        n_steps = pos_batches.shape[-3]
        for s in range(n_steps):
            pos = pos_batches[:, s] if stacked else pos_batches[s]
            neg = neg_batches[:, s] if stacked else neg_batches[s]
            pair, loss, grads = self._pairs_and_grads(params, pos, neg, cfg)
            params = apply_gradients(params, grads, cfg.learning_rate)
            if cfg.normalize == "step":
                params = self.normalize(params)
            stats = _accumulate_touch(stats, pos, neg, pair, E, R)
            loss_sum = loss_sum + loss
        shape = lambda t, n: None if t is None else t.reshape(
            (W, n) if stacked else (n,))
        return params, EpochStats(
            mean_loss=exact_div(loss_sum, n_steps),
            ent_count=shape(stats[0], E),
            ent_loss=shape(stats[1], E),
            rel_count=shape(stats[2], R),
            rel_loss=shape(stats[3], R),
        )

    def batch_gradients(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor,
        cfg: KGConfig
    ) -> tuple:
        """Loss and gradients for the BGD Map phase (§3.2.1): the workers
        emit gradients, never touching the params.  ``params`` are the
        shared ``(N, k)`` tables; a ``(W, B, 3)`` batch gives one loss and
        one gradient slice per worker, ``(W,)`` and ``(W, N, k)``."""
        _, loss, grads = self._pairs_and_grads(params, pos, neg, cfg,
                                               shared=True)
        return loss, grads
