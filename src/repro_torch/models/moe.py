"""Mixture-of-Experts FFN: shared + routed experts with top-k routing
(DeepSeek-V2 / Qwen-MoE style).  A port of ``repro.models.moe``'s scatter
dispatch, the one it takes without an ambient mesh.

Dispatch has a fixed capacity, so every shape is known before the data:
  * tokens pick their top-k experts; an exclusive cumulative sum over the
    (T·K, E) assignment matrix, in token-major pair order, gives each
    (token, expert) pair its slot; pairs at or past the capacity C are
    dropped (capacity-factor semantics; ``cf = E / K`` is dropless);
  * the kept pairs' rows are written into an (E_pad, C, d) buffer, each
    at its own (expert, slot), so the write needs no float atomics;
  * every expert's gated FFN is one batched product over the buffer;
  * each pair's output row is gathered back, weighted, and a token's K
    rows are summed in pair order (the reference's ``segment_sum``).

Dropped pairs are weighted by zero.  The routing, the slots and the keep
mask are integers equal to the reference's, ties included: ``_top_k``
keeps ``jax.lax.top_k``'s order (the larger probability first, the
lower expert first on a tie).

Under the LM mesh (``parallel/util.use_mesh``) each rank runs the FFN on
its own tokens.  Where the reference takes its ``shard_map`` dispatch
(an ambient mesh with ``model``, more than one data-parallel rank, the
padded experts dividing ``model``), ``parallel.util.local_params`` hands
each rank its block of ``E_pad / model`` experts (gathered over
``data`` under ``fsdp_tp``) and :func:`_apply_moe_shardmap` runs the
reference's expert-parallel dispatch: a local scatter into the block
with the local capacity, the block's FFN, and one sum over ``model``.
Elsewhere the rank's tokens take the scatter dispatch.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.common import ModelConfig, dense_init

# expert tensors are padded to a multiple of the model-axis size so they
# shard evenly (qwen2-moe's 60 experts -> 64 rows; the 4 dummies are never
# routed to — the router has exactly n_experts outputs).
EXPERT_PAD = 16


def padded_experts(cfg: ModelConfig) -> int:
    return -(-cfg.n_experts // EXPERT_PAD) * EXPERT_PAD


class MoEParams(nn.Module):
    """One MoE FFN's parameters under the reference's keys: ``router``
    (d, E) fp32, ``wg`` / ``wi`` (E_pad, d, f), ``wo`` (E_pad, f, d), and
    ``shared`` (a gated MLP) where the config has shared experts.  Read
    as a dict: ``p["wi"]``, ``"shared" in p``."""

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._parameters or key in self._modules


def init_moe(generator, cfg: ModelConfig, device=None) -> MoEParams:
    device = generator.device if device is None else device
    E, d, f, pd = padded_experts(cfg), cfg.d_model, cfg.moe_d_ff, \
        cfg.param_dtype
    p = MoEParams()
    p.router = dense_init(generator, (d, cfg.n_experts), d, torch.float32,
                          device)
    p.wg = dense_init(generator, (E, d, f), d, pd, device)
    p.wi = dense_init(generator, (E, d, f), d, pd, device)
    p.wo = dense_init(generator, (E, f, d), f, pd, device)
    if cfg.n_shared_experts:
        p.shared = common.init_mlp(generator, d, cfg.n_shared_experts * f,
                                   cfg, gated=True, device=device)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (``torch.topk`` promises no order for ties; a stable
    descending sort keeps equal entries in index order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _route(p, x_flat: torch.Tensor, cfg: ModelConfig):
    """x_flat (T, d) -> (weights (T, K) fp32, experts (T, K) int64,
    aux_loss fp32 scalar)."""
    logits = x_flat.float() @ p["router"].float()                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = _top_k(probs, cfg.top_k)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    weights = weights * cfg.routed_scaling
    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)                                       # (E,)
    ce = nn.functional.one_hot(experts[:, 0], cfg.n_experts).float().mean(
        dim=0)                                                   # top-1 frac
    aux = cfg.n_experts * torch.sum(me * ce)
    return weights, experts, aux


def capacity_of(T: int, cfg: ModelConfig) -> int:
    """Slots an expert: ``cf = E / K`` is exactly dropless (C = T); the
    floor of 8 keeps tiny decode batches from starving an expert."""
    E, K = cfg.n_experts, cfg.top_k
    return min(max(int((T * K * cfg.capacity_factor) / E), min(8, T)), T)


def _slots(experts: torch.Tensor, cfg: ModelConfig):
    """Each (token, k) pair's place in its expert, token-major:
    (flat_exp (T·K,), slot (T·K,), keep (T·K,) bool, capacity)."""
    T, K = experts.shape
    flat_exp = experts.reshape(T * K)
    onehot = nn.functional.one_hot(flat_exp, cfg.n_experts).to(torch.int32)
    pos_in_expert = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(pos_in_expert, 1, flat_exp[:, None])[:, 0]
    capacity = capacity_of(T, cfg)
    return flat_exp, slot, slot < capacity, capacity


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B, L, d) -> (out (B, L, d), aux_loss fp32 scalar): the
    expert-parallel dispatch where this rank holds a block of the experts
    (see the module docstring), else the scatter dispatch."""
    from repro_torch.parallel import util as par

    ctx = par.mesh_context()
    if ctx is not None and p["wi"].shape[0] != padded_experts(cfg):
        dp = tuple(a for a in ("pod", "data")
                   if a in ctx.mesh.mesh_dim_names)
        return _apply_moe_shardmap(p, x, cfg, ctx.mesh, dp)
    return _apply_moe_scatter(p, x, cfg)


def _dispatch(x_flat, flat_e, slot, keep, n_exp: int, C: int, p,
              cfg: ModelConfig, x_in=None):
    """Each kept pair's row of ``x_in`` (default ``x_flat``) into its own
    (expert, slot) of an (n_exp, C, d) buffer, the experts' gated FFN on
    it, and every pair's output row gathered back (a dropped pair reads
    expert 0's last slot, as the reference does; its weight is zero):
    (T·K, d)."""
    T, d = x_flat.shape
    K = flat_e.shape[0] // T
    x_in = x_flat if x_in is None else x_in
    # the dropped pairs go to a spare row past the buffer, never read
    row = flat_e * C + slot
    spare = torch.full_like(row, n_exp * C)
    buf = torch.zeros((n_exp * C + 1, d), dtype=cfg.dtype,
                      device=x_flat.device)
    tok_ids = torch.arange(T, device=x_flat.device).repeat_interleave(K)
    buf[torch.where(keep, row, spare)] = x_in[tok_ids].to(cfg.dtype)
    buf = buf[:n_exp * C].view(n_exp, C, d)

    # block-diagonal batched products
    act = common.act_fn(cfg.act)
    up = torch.bmm(buf, p["wi"].to(cfg.dtype))
    gate = act(torch.bmm(buf, p["wg"].to(cfg.dtype)))
    out_e = torch.bmm(gate * up, p["wo"].to(cfg.dtype))          # (n,C,d)

    safe = torch.where(keep, row, torch.full_like(row, C - 1))
    return out_e.reshape(n_exp * C, d)[safe]


def _combine(gathered, w_flat, T: int, K: int):
    """Weight each pair's row and sum each token's K rows in pair order
    (the reference's ``segment_sum``)."""
    contrib = (gathered * w_flat[:, None]).view(T, K, -1)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def _apply_moe_scatter(p, x: torch.Tensor, cfg: ModelConfig):
    B, L, d = x.shape
    T, K = B * L, cfg.top_k
    E_pad = padded_experts(cfg)
    x_flat = x.reshape(T, d)

    weights, experts, aux = _route(p, x_flat, cfg)
    flat_exp, slot, keep, C = _slots(experts, cfg)
    gathered = _dispatch(x_flat, flat_exp, slot, keep, E_pad, C, p, cfg)
    w_flat = (weights.reshape(T * K) * keep).to(cfg.dtype)
    out = _combine(gathered, w_flat, T, K)

    if cfg.n_shared_experts:
        out = out + common.apply_mlp(p["shared"], x_flat, cfg)
    return out.reshape(B, L, d), aux.float()


# ---------------------------------------------------------------------------
# expert-parallel dispatch (the reference's shard_map body)
# ---------------------------------------------------------------------------

def _apply_moe_shardmap(p, x: torch.Tensor, cfg: ModelConfig, mesh, dp):
    """The expert-parallel dispatch, run by every rank of the mesh on its
    own tokens: x (B_loc, L, d), this rank's shard of the batch over the
    ``dp`` axes (whole over ``model``); ``p["wg"]`` / ``["wi"]`` /
    ``["wo"]`` this ``model`` rank's block of ``e_loc = E_pad / model``
    experts, whole over ``data``; the router whole.

    Every ``model`` rank routes all its tokens, keeps the pairs that
    chose its block, scatters them into (e_loc, cap, d) with the local
    capacity ``max(int(t_loc·K·cf/E), min(8, t_loc))`` (at most t_loc),
    runs its experts, combines, and one sum over ``model`` adds the
    blocks' contributions.  The aux loss's factors ``me`` and ``ce`` are
    averaged over ``dp`` before their product, so it equals the global
    batch's.  Gradients: the tokens and routing weights enter the
    ``model``-cut work whole (their cotangents summed over ``model``),
    the sum leaves it whole (its cotangent passed through), and the mean
    over ``dp`` is a sum both ways, as every rank's loss is its share of
    the global one."""
    from repro_torch.parallel import util as par

    B, L, d = x.shape
    t_loc = B * L
    E, K = cfg.n_experts, cfg.top_k
    e_loc = p["wi"].shape[0]
    x_loc = x.reshape(t_loc, d)
    cap = min(max(int(t_loc * K * cfg.capacity_factor / E), min(8, t_loc)),
              t_loc)

    probs = torch.softmax(x_loc.float() @ p["router"].float(), dim=-1)
    weights, experts = _top_k(probs, K)                          # (t_loc,K)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    weights = weights * cfg.routed_scaling
    lo = mesh.get_local_rank("model") * e_loc
    mine = (experts >= lo) & (experts < lo + e_loc)              # (t_loc,K)
    flat_e = torch.where(mine, experts - lo, 0).reshape(t_loc * K)
    flat_keep = mine.reshape(t_loc * K)
    onehot = nn.functional.one_hot(flat_e, e_loc).to(torch.int32) * \
        flat_keep[:, None].to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = flat_keep & (slot < cap)

    gathered = _dispatch(x_loc, flat_e, slot, keep, e_loc, cap, p, cfg,
                         x_in=par.copy_to(x_loc, mesh, "model"))
    w_in = par.copy_to(weights, mesh, "model")
    w_flat = (w_in.reshape(t_loc * K) * keep).to(cfg.dtype)
    out = par.reduce_from(_combine(gathered, w_flat, t_loc, K), mesh,
                          "model")

    # Switch-style aux loss over the global batch
    dp_size = 1
    for a in dp:
        dp_size *= par.mesh_axis_size(mesh, a)
    me = par.psum(probs.mean(dim=0), mesh, dp) / dp_size
    ce = par.psum(nn.functional.one_hot(experts[:, 0], E).float().mean(
        dim=0), mesh, dp) / dp_size
    aux = E * torch.sum(me * ce)

    if cfg.n_shared_experts:
        out = out + common.apply_mlp(p["shared"], x_loc, cfg)
    return out.reshape(B, L, d), aux.float()
