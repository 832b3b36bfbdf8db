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
the per-triplet objective through ``kernels/ops.kg_pair_loss``, whose
backward is the closed form of the ``transe_score_bwd`` kernel; the
reference takes ``jax.grad`` of ``margin_loss``.  The two agree at rtol
1e-4, atol 1e-5 (``tests/test_torch_kernels_transe_score.py``).  Every
other model, and the joint objective of every model (``negatives=
"joint"``, DGL-KE's shared candidate pool), trains by torch autograd of
the plain scorers, as the reference does by ``jax.grad``: an in-order sum
(:func:`in_order_sum`) differentiates as one broadcast of its upstream
gradient, the exact gradient of a sum, so autograd does not retrace the
``k`` slices it was summed from.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import merge, negative
from repro_torch.util import (
    not_ported, ordered_index_add, pairwise_mean, pairwise_sum, sqrt_rn,
    worker_offsets)

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
    # corrupted counterpart (Eq. 3, the paper); 'joint' scores a shared
    # candidate pool — the batch's first ``neg_candidates`` corrupted
    # entities — against EVERY positive of the batch (DGL-KE's joint
    # negative sampling: B·C ranking pairs a batch instead of B)
    negatives: str = "pertriplet"
    # 'joint' pool size C (clamped to the batch size); 0 = the full batch
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


class _FixedOrderSum(torch.autograd.Function):
    """A sum over the last axis taken in a fixed order (``reduce``), whose
    backward is the exact gradient of any sum: the upstream gradient
    broadcast to every term.  Autograd of the sum's own slices and
    additions would launch two or three kernels a term."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.shape = x.shape
        return reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(ctx.shape), None


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` for a 2-D table, whose backward sums each row's
    contributions one at a time in the order of ``ids``, from ``+0.0``,
    with no host sync: ``index_add_`` on the CPU (a serial loop over the
    ids), ``index_put_(accumulate=True)`` on CUDA (a stable sort by row,
    then each row's run summed in order).  Autograd's own backward of a
    gather is ``index_put_(accumulate=True)`` on both, which on the CPU
    adds with parallel atomics once the gradient has ``GRAIN_SIZE``
    elements, so its bits change from run to run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        flat = ids.reshape(-1)
        rows = g.reshape(flat.shape[0], -1)
        out = g.new_zeros(ctx.shape)
        if out.is_cuda:
            out.index_put_((flat,), rows, accumulate=True)
        else:
            out.index_add_(0, flat, rows)
        return out, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (``table`` 2-D), differentiable with a run-to-run
    fixed backward (:class:`_GatherRows`): the gathers of every trained
    scorer go through it."""
    return _GatherRows.apply(table, ids)


def _last_in_order(x: torch.Tensor) -> torch.Tensor:
    return _seq_sum(lambda j: x[..., j], x.shape[-1])


def in_order_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ_j x[..., j]`` over the last axis in index order ``j = 0 .. k-1``,
    one rounding per addition, differentiable (:class:`_FixedOrderSum`)."""
    return _FixedOrderSum.apply(x, _last_in_order)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as ``util.pairwise_sum``'s balanced tree (the
    same bits on every device, log2 n launches), differentiable."""
    return _FixedOrderSum.apply(x, pairwise_sum)


def seq_total(part: Callable[[int], torch.Tensor], k: int) -> torch.Tensor:
    """``Σ_j part(j)`` in index order, the signed counterpart of
    :func:`seq_distance` (half precision summed in float32, rounded once to
    its dtype), for the bilinear and projection scorers."""
    first = part(0)
    total = _seq_sum(lambda j: _wide(first if j == 0 else part(j)), k)
    return total.to(first.dtype)


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
    return _finish(in_order_sum(terms), x.dtype, norm)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization (the constraint projection primitive),
    ``x / (sqrt(Σ_j x_j²) + 1e-12)`` with the squares summed in index
    order, so a projection gives the same bits on the CPU and the card."""
    w = _wide(x)
    norm = sqrt_rn(in_order_sum(w * w).to(x.dtype))
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

    # scalar, mean loss over the epoch: util.pairwise_mean over the steps
    # of each step's loss (its pairs' util.pairwise_mean, or the joint
    # margin loss)
    mean_loss: torch.Tensor
    ent_count: torch.Tensor     # (E,) how many updates touched each entity
    # (E,) summed pair loss attributed to entity; None when the epoch was
    # run without touch losses (only miniloss_perkey reads them)
    ent_loss: Optional[torch.Tensor]
    rel_count: torch.Tensor     # (R,)
    rel_loss: Optional[torch.Tensor]  # (R,)


def _flatten_workers(params: Params, *trips):
    """Stacked ``(W, N, k)`` tables as ``(W·N, k)`` and ``(W, …, 3)``
    triplets with each worker's ids offset onto its rows, so a plain
    scorer scores all workers at once, each against its own rows only;
    unstacked inputs pass through.  Returns ``(params, *trips)``."""
    if params["ent"].dim() == 2:
        return (params,) + trips
    flat = {name: t.reshape(-1, t.shape[-1]) for name, t in params.items()}
    out = []
    for trip in trips:
        eo, ro = worker_offsets(trip, params["ent"].shape[1],
                                params["rel"].shape[1])
        lead = (trip.shape[0],) + (1,) * (trip.dim() - 2)
        off = torch.stack([eo.reshape(lead), ro.reshape(lead),
                           eo.reshape(lead)], dim=-1)     # (W, 1…, 3)
        out.append(trip.long() + off)
    return (flat,) + tuple(out)


def _masked_mean(hinges: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``Σ hinges / max(Σ valid, 1)`` over the last axis, the hinges summed
    as a fixed tree (:func:`tree_sum`); ``valid`` holds 0s and 1s, whose
    sum is exact in any order."""
    return tree_sum(hinges) / valid.sum(-1).clamp_min(1.0)


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

    def normalize_rows(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """Row-local restriction of :meth:`normalize` for table ``name``:
        the projection applied to a ``(n, k)`` slice of rows, so that
        ``normalize(params)[name][ids]`` equals ``normalize_rows(name,
        params[name][ids])`` bitwise (the sparse transport's contract).
        Default: unit-L2 rows for ``"ent"``, identity elsewhere."""
        if name == "ent":
            return unit_rows(rows)
        return rows

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

    def candidate_slice_energies(
        self, params: Params, triplets: torch.Tensor, side: str,
        norm: str = "l1", *, lo: int, n: int
    ) -> torch.Tensor:
        """Columns ``[lo, lo + n)`` of :meth:`candidate_energies`, ``(B, 3)
        -> (B, n)``: the shard-local candidate scan of sharded tables.
        Contract: **bitwise** the slice of the full matrix.  The generic
        fallback slices the full matrix; models override to touch only the
        candidate rows (the caller keeps ``lo + n <= E``)."""
        return self.candidate_energies(
            params, triplets, side, norm)[:, lo:lo + n]

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
        margin: float, norm: str, check_ids: bool = True
    ) -> torch.Tensor:
        """Differentiable per-pair hinge through the model's kernels
        (``check_ids=False``: the caller has proved the ids in range, and
        the kernels skip their checks and host syncs).  A model declaring
        ``supports_fused_kernel = True`` MUST override this and the two
        hooks below: the dispatch in kernels/ops.py calls them blindly."""
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

    # -- joint negative scoring (DGL-KE's shared candidate pool) ------------
    #
    # Triplets may carry leading axes, ``(…, B, 3)``: the pool, the masks
    # and the energies then carry them too, ``(…, C)`` and ``(…, B, C)``.
    # With stacked ``(W, N, k)`` tables the leading axis is the worker
    # axis, and each worker scores its own B positives against its own
    # pool of C candidates, never another worker's.

    def joint_parts(self, pos: torch.Tensor, neg: torch.Tensor,
                    n_candidates: int) -> tuple:
        """``(cand, side_head)``: the pool is the batch's first C corrupted
        entities ``(…, C)``, and ``side_head`` ``(…, B)`` marks which side
        each positive's corruption replaced.  No new randomness: the pool
        reuses the per-triplet negatives."""
        side_head = neg[..., 0] != pos[..., 0]
        corrupted = torch.where(side_head, neg[..., 0], neg[..., 2])
        B = corrupted.shape[-1]
        C = B if n_candidates == 0 else min(n_candidates, B)
        return corrupted[..., :C], side_head

    def joint_energies(
        self, params: Params, pos: torch.Tensor, cand: torch.Tensor,
        side_head: torch.Tensor, norm: str = "l1"
    ) -> torch.Tensor:
        """Energy of every candidate substituted into every positive's
        corruption side, ``(…, B, C)``, on unstacked tables.  The generic
        fallback builds the ``(…, B, C, 3)`` substituted triplets and
        scores them in one :meth:`energy` call, so with per-triplet
        candidates its diagonal is ``energy(neg)`` bitwise.  Models
        override with closed forms."""
        pos = _long(pos)
        e = _long(cand)[..., None, :]                     # (…, 1, C)
        side = side_head[..., None]
        h = torch.where(side, e, pos[..., 0, None])
        t = torch.where(side, pos[..., 2, None], e)
        trip = torch.stack([h, pos[..., 1, None].expand_as(h), t], dim=-1)
        return self.energy(params, trip, norm)

    def joint_hinges(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor, *,
        margin: float, norm: str, n_candidates: int = 0
    ) -> tuple:
        """The ``(…, B, C)`` hinge matrix of the joint objective and its
        validity mask: a candidate equal to a positive's gold entity on the
        corrupted side is a false negative and is masked out (Eq. 2's
        constraint)."""
        pos, neg = _long(pos), _long(neg)
        cand, side_head = self.joint_parts(pos, neg, n_candidates)
        gold = torch.where(side_head, pos[..., 0], pos[..., 2])
        valid = (cand[..., None, :] != gold[..., None]).to(
            params["ent"].dtype)
        flat, fpos = _flatten_workers(params, pos)
        if flat is not params:           # stacked: (W, C) onto worker rows
            cand = cand + worker_offsets(cand, params["ent"].shape[1])[0]
        d_pos = self.energy(flat, fpos, norm)              # (…, B)
        d_cand = self.joint_energies(flat, fpos, cand, side_head, norm)
        return pairwise_hinge(d_pos[..., None], d_cand, margin) * valid, valid

    def joint_margin_loss(
        self, params: Params, pos, neg, *, margin: float, norm: str,
        n_candidates: int = 0
    ) -> torch.Tensor:
        """Mean hinge over the B·C valid (positive, candidate) pairs, ``Σ
        hinges / max(Σ valid, 1)``: the joint analogue of
        :meth:`margin_loss` and the joint step's loss."""
        hinges, valid = self.joint_hinges(
            params, pos, neg, margin=margin, norm=norm,
            n_candidates=n_candidates)
        return _masked_mean(hinges.flatten(-2), valid.flatten(-2))

    def joint_pair_loss(
        self, params: Params, pos, neg, *, margin: float, norm: str,
        n_candidates: int = 0
    ) -> torch.Tensor:
        """Per positive, the mean hinge over its valid candidates, ``(…,
        B)``: the joint analogue of :meth:`per_pair_loss`, for the touch
        stats only (the step's loss is :meth:`joint_margin_loss`)."""
        hinges, valid = self.joint_hinges(
            params, pos, neg, margin=margin, norm=norm,
            n_candidates=n_candidates)
        return _masked_mean(hinges, valid)

    def _objective(self, params: Params, pos, neg, cfg: KGConfig,
                   check_ids: bool = True) -> tuple:
        """``(pair losses, step loss)`` of one step from one scoring of the
        batch, the step loss differentiable: the training objective
        ``cfg.negatives`` selects (the reference's ``_loss_fn`` and
        ``_pair_loss_fn`` in one).  Per-triplet: the model-dispatched hinge
        of ``kernels/ops.kg_pair_loss`` (the kernels for fused models) and
        its mean.  Joint: :meth:`joint_margin_loss`, with
        :meth:`joint_pair_loss` for the touch stats only, in plain
        PyTorch for every model, as the reference's is plain jnp."""
        if cfg.negatives == "joint":
            hinges, valid = self.joint_hinges(
                params, pos, neg, margin=cfg.margin, norm=cfg.norm,
                n_candidates=cfg.neg_candidates)
            return (_masked_mean(hinges.detach(), valid),
                    _masked_mean(hinges.flatten(-2), valid.flatten(-2)))
        from repro_torch.kernels import ops

        pair = ops.kg_pair_loss(self, params, pos, neg, margin=cfg.margin,
                                norm=cfg.norm, check_ids=check_ids)
        return pair, pair.mean(-1)

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
        """Hinge per (pos, neg) pair, ``pos.shape[:-1]``; pos and neg are
        scored in one :meth:`energy` call (elementwise per triplet, so the
        same bits as two)."""
        params, pos, neg = _flatten_workers(params, pos, neg)
        d = self.energy(params, torch.stack([_long(pos), _long(neg)]), norm)
        return pairwise_hinge(d[0], d[1], margin)

    def _pairs_and_grads(self, params: Params, pos, neg, cfg: KGConfig,
                         shared: bool = False, check_ids: bool = True):
        """``(pair losses, step loss, grads)`` of one step: the objective on
        ``params`` (:meth:`_objective`) and its gradient with respect to
        every table.  The step loss returned is summed in a fixed order
        (``util.pairwise_mean`` of the pairs, or the joint loss's tree),
        the same bits on every device.

        With ``shared`` and a ``(W, B, 3)`` batch the tables are one set of
        ``(N, k)`` tables that all W workers read (BGD): they enter as a
        worker-stride-0 view ``(W, N, k)``, so each worker's gradient comes
        back in its own ``(N, k)`` slice.  ``check_ids=False`` (the
        training engine, which proves its ids in range once per run) makes
        the step free of host syncs: see ``kernels/transe_score.py``."""
        if shared and pos.dim() == 3:
            W = pos.shape[0]
            leaves = {name: p.detach().expand(W, *p.shape).requires_grad_()
                      for name, p in params.items()}
        else:
            leaves = {name: p.detach().requires_grad_()
                      for name, p in params.items()}
        names = sorted(leaves)
        with torch.enable_grad():
            pair, loss = self._objective(leaves, pos, neg, cfg, check_ids)
            grads = torch.autograd.grad(loss.sum(),
                                        [leaves[n] for n in names])
        if cfg.negatives == "joint":
            loss = loss.detach()
        else:
            pair = pair.detach()
            loss = pairwise_mean(pair)
        return pair, loss, dict(zip(names, grads))

    def sgd_step(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor,
        cfg: KGConfig
    ) -> tuple:
        """One (mini-batch) SGD step of Algorithm 1's inner loop:
        ``(params, loss)``, the objective from ``cfg.negatives``; stacked
        tables with a ``(W, B, 3)`` batch step every worker's own copy."""
        _, loss, grads = self._pairs_and_grads(params, pos, neg, cfg)
        params = apply_gradients(params, grads, cfg.learning_rate)
        if cfg.normalize == "step":
            params = self.normalize(params)
        return params, loss

    def _compact_batch(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor,
        cfg: KGConfig
    ) -> tuple:
        """``(cand, compact, pos_c, neg_c)`` for one batch: per table role
        the rows the batch references, distinct and sorted, in a buffer of
        static size (``min(E, 4B)`` entity and ``min(R, 2B)`` relation
        slots, padded with the out-of-range id ``n_rows``); the tables
        gathered at them (zero at pads); the triplets remapped onto them.
        With stacked ``(W, N, k)`` tables and ``(W, B, 3)`` batches every
        worker has its own candidates, ``(W, U)``, and compact tables,
        ``(W, U, k)``.  Under the joint objective the pool is the
        negatives' corrupted heads or tails, which the entity candidates
        hold.  The remap is a binary search in the sorted candidates:
        monotonic and injective, so it keeps the order of every row's
        contributions and every equality between ids."""
        pos, neg = pos.long(), neg.long()
        ent_ids = torch.cat([pos[..., 0], pos[..., 2], neg[..., 0],
                             neg[..., 2]], dim=-1)
        rel_ids = torch.cat([pos[..., 1], neg[..., 1]], dim=-1)
        E, R = cfg.n_entities, cfg.n_relations
        cand = {
            "ent": merge.sized_unique(
                ent_ids, int(min(E, ent_ids.shape[-1])), E),
            "rel": merge.sized_unique(
                rel_ids, int(min(R, rel_ids.shape[-1])), R),
        }
        roles = self.param_roles()
        d = pos.dim() - 2                       # 1 for stacked tables
        compact = {name: merge.take_fill(t, cand[roles[name]], d)
                   for name, t in params.items()}

        def remap(t):
            return torch.stack([
                torch.searchsorted(cand[role], t[..., col].contiguous())
                for col, role in enumerate(("ent", "rel", "ent"))], dim=-1)

        return cand, compact, remap(pos), remap(neg)

    def _sparse_update_(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor,
        cfg: KGConfig, check_ids: bool = True
    ) -> tuple:
        """The compact SGD step written in place into ``params`` (tables
        the caller owns): the objective and its gradient on the compact
        tables of :meth:`_compact_batch`, ``compact - lr · grad``, and
        those rows scattered back (pads dropped).  Returns ``(pair
        losses, step loss)``; the projection of ``normalize="step"`` is
        the caller's."""
        cand, compact, pos_c, neg_c = self._compact_batch(params, pos, neg,
                                                          cfg)
        # the remap keeps id (in)equality, so the joint objective's sides,
        # pool and gold masks are the same booleans on the compact ids
        pair, loss, grads = self._pairs_and_grads(compact, pos_c, neg_c, cfg,
                                                  check_ids=check_ids)
        stepped = apply_gradients(compact, grads, cfg.learning_rate)
        roles = self.param_roles()
        for name in params:
            merge.put_drop_(params[name], cand[roles[name]], stepped[name])
        return pair, loss

    def sgd_step_sparse(
        self, params: Params, pos: torch.Tensor, neg: torch.Tensor,
        cfg: KGConfig, update_mask: Optional[Params] = None
    ) -> tuple:
        """:meth:`sgd_step` touching only the rows the batch references —
        the Map half of the sparse transport (``merge_transport=
        "sparse"``): per step one gather and one scatter of the batch's
        rows, and the objective, its gradient (for TransE the
        ``transe_score`` kernels) and the update on compact ``(…, U, k)``
        tables instead of the whole ``(…, N, k)`` ones.

        The same bits as :meth:`sgd_step`: gathers compose, so the forward
        computes the same floats; the gradient sums each row's
        contributions in the same order (the remap is monotonic, and the
        sums are in-order or sorted stably by row); and a row no id
        references has a dense gradient of exactly ``+0.0``, where ``p -
        lr · 0.0`` is ``p``, so leaving it out changes nothing.
        ``update_mask`` (the online tier's masked fine-tune) is not ported
        yet."""
        if update_mask is not None:
            raise not_ported("sgd_step_sparse(update_mask=...)", 14)
        params = {name: p.clone() for name, p in params.items()}
        _, loss = self._sparse_update_(params, pos, neg, cfg)
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
        check_ids: bool = True,
    ) -> tuple:
        """One epoch of Algorithm 1: constraint projection, then SGD over
        the minibatches in order, tracking the per-key stats the Reduce
        needs.  With ``(W, N, k)`` tables and ``(W, S, B, 3)`` batches all W
        workers run side by side, each on its own copy; the stats then
        carry a leading worker axis.  ``touch_losses=False`` leaves the
        per-key loss sums out (``None``): only ``miniloss_perkey`` reads
        them, and they are the dearest part of the stats (and their
        in-order sums, ``util.ordered_index_add``, read a count back to the
        host).  ``check_ids``: see :meth:`_pairs_and_grads`.
        ``sparse_apply`` takes the compact step of :meth:`sgd_step_sparse`
        in place of the dense one (same bits), writing the stepped rows in
        place into copies of the tables the epoch owns; per worker for
        stacked batches.  Returns ``(params, EpochStats)``."""
        if update_mask is not None:
            raise not_ported("run_epoch(update_mask=...)", 14)
        given = params
        if cfg.normalize == "epoch":
            params = self.normalize(params)
        if sparse_apply:
            params = {name: p.clone() if p is given[name] else p
                      for name, p in params.items()}
        stacked = pos_batches.dim() == 4
        W = pos_batches.shape[0] if stacked else 1
        E, R = cfg.n_entities, cfg.n_relations
        dev = params["ent"].device
        zeros = lambda n: torch.zeros(W * n, dtype=cfg.dtype, device=dev)
        stats = (zeros(E), zeros(E) if touch_losses else None, zeros(R),
                 zeros(R) if touch_losses else None)
        losses = []
        for s in range(pos_batches.shape[-3]):
            pos = pos_batches[:, s] if stacked else pos_batches[s]
            neg = neg_batches[:, s] if stacked else neg_batches[s]
            if sparse_apply:
                pair, loss = self._sparse_update_(params, pos, neg, cfg,
                                                  check_ids)
            else:
                pair, loss, grads = self._pairs_and_grads(
                    params, pos, neg, cfg, check_ids=check_ids)
                params = apply_gradients(params, grads, cfg.learning_rate)
            if cfg.normalize == "step":
                params = self.normalize(params)
            stats = _accumulate_touch(stats, pos, neg, pair, E, R)
            losses.append(loss)
        shape = lambda t, n: None if t is None else t.reshape(
            (W, n) if stacked else (n,))
        return params, EpochStats(
            mean_loss=pairwise_mean(torch.stack(losses), 0),
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
