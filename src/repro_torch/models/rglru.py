"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).
A port of ``repro.models.rglru``.

Block:  x -> [gate branch: linear -> GeLU (tanh)] ⊙ [rec branch: linear
-> causal conv1d(K) -> RG-LRU] -> out linear.

RG-LRU recurrence (elementwise, per channel):
    r_t = sigmoid(W_a u_t + b_a)          recurrence gate
    i_t = sigmoid(W_x u_t + b_x)          input gate
    a_t = exp(-c * softplus(Λ) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

Linear in h, so prefill runs it as ``common.linear_scan`` over the
positions (log-depth; the reference's ``jax.lax.associative_scan``, in
another summation order) and decode as an O(1) update of an fp32
(B, d_rnn) state, the same size at any context length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.common import ModelConfig, dense_init, zeros_init


def _gate_blocks(cfg: ModelConfig) -> int:
    """``rglru_blocks`` halved until it divides ``d_rnn``."""
    dr = cfg.d_rnn
    nb = cfg.rglru_blocks
    while nb > 1 and dr % nb != 0:
        nb //= 2
    return max(nb, 1)


def init_rglru(generator, cfg: ModelConfig,
               device=None) -> nn.ParameterDict:
    """The reference's keys and shapes, the block-diagonal gates
    (nb, drb, drb); ``lam`` the reference's constant, so that ``a`` lies
    in (0.9, 0.999) at ``r = 1``."""
    device = generator.device if device is None else device
    d, dr, K, pd = cfg.d_model, cfg.d_rnn, cfg.conv_kernel, cfg.param_dtype
    nb = _gate_blocks(cfg)
    drb = dr // nb
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, dr, dtype=torch.float32,
                                  device=device)) / cfg.rglru_c))
    return nn.ParameterDict({
        "w_rec_in": dense_init(generator, (d, dr), d, pd, device),
        "w_gate_in": dense_init(generator, (d, dr), d, pd, device),
        "conv_w": dense_init(generator, (K, dr), K, pd, device),
        "conv_b": zeros_init((dr,), pd, device),
        "w_a": dense_init(generator, (nb, drb, drb), drb, pd, device),
        "b_a": zeros_init((dr,), pd, device),
        "w_x": dense_init(generator, (nb, drb, drb), drb, pd, device),
        "b_x": zeros_init((dr,), pd, device),
        "lam": common._param(lam.to(pd)),
        "w_out": dense_init(generator, (dr, d), dr, pd, device),
    })


class RGLRUCache(NamedTuple):
    h: torch.Tensor            # (B, d_rnn) hidden state (fp32)
    conv: torch.Tensor         # (B, K-1, d_rnn) trailing raw inputs


def init_rglru_cache(cfg: ModelConfig, batch: int,
                     device=None) -> RGLRUCache:
    return RGLRUCache(
        h=torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_rnn),
                         dtype=cfg.dtype, device=device),
    )


def _gates(p, u: torch.Tensor, cfg: ModelConfig):
    """u (B, L, d_rnn) -> (a, gated input), both fp32 (B, L, d_rnn)."""
    B, L, dr = u.shape
    nb, drb, _ = p["w_a"].shape
    ub = u.reshape(B, L, nb, drb)

    def gate(w, b):
        proj = torch.einsum("blnd,nde->blne", ub, w.to(cfg.dtype))
        return torch.sigmoid(proj.reshape(B, L, dr).float() + b.float())

    r = gate(p["w_a"], p["b_a"])
    i = gate(p["w_x"], p["b_x"])
    log_a = -cfg.rglru_c * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i * u.float())
    return a, gated_in


def apply_rglru(
    p,
    x: torch.Tensor,           # (B, L, d_model)
    cfg: ModelConfig,
    cache: Optional[RGLRUCache] = None,
    decode: bool = False,
):
    """Returns (out (B, L, d), new_cache): the new cache is None without
    ``cache``."""
    B, L, _ = x.shape
    gate = common._gelu_tanh(
        torch.einsum("bld,de->ble", x, p["w_gate_in"].to(cfg.dtype)))
    u = torch.einsum("bld,de->ble", x, p["w_rec_in"].to(cfg.dtype))

    w = p["conv_w"].to(cfg.dtype)
    cb = p["conv_b"].to(cfg.dtype)
    new_conv = None
    if decode:
        assert cache is not None and L == 1
        window = torch.cat([cache.conv, u], dim=1)
        u = (torch.einsum("bkc,kc->bc", window, w) + cb)[:, None]
        new_conv = window[:, 1:]
    else:
        raw = u
        u = common.causal_conv(u, w) + cb
        if cache is not None:
            K = cfg.conv_kernel
            new_conv = raw[:, -(K - 1):] if L >= K - 1 else torch.cat(
                [cache.conv[:, L:], raw], dim=1)

    a, gin = _gates(p, u, cfg)                                 # fp32 (B,L,dr)

    if decode:
        h = cache.h * a[:, 0] + gin[:, 0]
        y = h[:, None]
        new_h = h
    else:
        h0 = cache.h if cache is not None else torch.zeros(
            (B, cfg.d_rnn), dtype=torch.float32, device=x.device)
        aa, bb = common.linear_scan(a, gin, dim=1)
        y = aa * h0[:, None] + bb                              # (B,L,dr)
        new_h = y[:, -1]

    out = y.to(cfg.dtype) * gate
    out = torch.einsum("ble,ed->bld", out, p["w_out"].to(cfg.dtype))
    new_cache = (RGLRUCache(h=new_h, conv=new_conv)
                 if cache is not None else None)
    return out, new_cache
