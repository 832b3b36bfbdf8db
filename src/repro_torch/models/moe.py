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
lower expert first on a tie).  The expert-parallel dispatch over a
``model`` mesh axis (``_apply_moe_shardmap``) is ROADMAP item 16f.
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
    """x (B, L, d) -> (out (B, L, d), aux_loss fp32 scalar): the scatter
    dispatch."""
    B, L, d = x.shape
    T, K = B * L, cfg.top_k
    E_pad = padded_experts(cfg)
    x_flat = x.reshape(T, d)

    weights, experts, aux = _route(p, x_flat, cfg)
    flat_exp, slot, keep, C = _slots(experts, cfg)

    # ---- dispatch: each kept pair's row to its own (expert, slot); the
    # dropped ones to a spare row past the buffer, never read
    row = flat_exp * C + slot
    spare = torch.full_like(row, E_pad * C)
    buf = torch.zeros((E_pad * C + 1, d), dtype=cfg.dtype, device=x.device)
    tok_ids = torch.arange(T, device=x.device).repeat_interleave(K)
    buf[torch.where(keep, row, spare)] = x_flat[tok_ids].to(cfg.dtype)
    buf = buf[:E_pad * C].view(E_pad, C, d)

    # ---- per-expert FFN: block-diagonal batched products
    act = common.act_fn(cfg.act)
    up = torch.bmm(buf, p["wi"].to(cfg.dtype))
    gate = act(torch.bmm(buf, p["wg"].to(cfg.dtype)))
    out_e = torch.bmm(gate * up, p["wo"].to(cfg.dtype))          # (E_pad,C,d)

    # ---- combine: gather back (a dropped pair reads expert 0's last slot,
    # as the reference does, weighted by zero) and sum each token's K rows
    # in pair order
    safe = torch.where(keep, row, torch.full_like(row, C - 1))
    gathered = out_e.reshape(E_pad * C, d)[safe]                  # (T·K, d)
    w_flat = (weights.reshape(T * K) * keep).to(cfg.dtype)
    contrib = (gathered * w_flat[:, None]).view(T, K, d)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]

    if cfg.n_shared_experts:
        out = out + common.apply_mlp(p["shared"], x_flat, cfg)
    return out.reshape(B, L, d), aux.float()
