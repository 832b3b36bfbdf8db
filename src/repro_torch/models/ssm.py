"""Mamba-2 / SSD (state-space duality) layer [arXiv:2405.21060].  A port
of ``repro.models.ssm``.

Prefill runs the SSD chunked algorithm: within a chunk of ``ssm_chunk``
positions, dense masked products (``torch.einsum``); across chunks, the
elementwise linear recurrence ``s_c = exp(Σ a in chunk c) · s_{c-1} +
states_c``, which the reference runs as ``jax.lax.associative_scan`` and
the port as ``common.linear_scan`` (log-depth, another summation order).
A prompt is padded with zeros to a multiple of the chunk; zero ``a`` and
zero ``x`` leave the final state as it was at the prompt's end.

Decode is the O(1)-per-token recurrent form with an explicit (B, H, P, N)
fp32 state and the causal conv's last K-1 raw inputs, so the state is the
same size at any context length and has no slot limit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.common import (
    ModelConfig, dense_init, rms_norm, zeros_init)


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1                                     # n_groups
    conv_dim = d_inner + 2 * G * N
    return d_inner, H, N, G, conv_dim


def init_ssm(generator, cfg: ModelConfig, device=None) -> nn.ParameterDict:
    """The reference's keys and shapes; ``in_proj``, ``conv_w`` and
    ``out_proj`` drawn in that order, the rest the reference's constants
    (``A_log = log(linspace(1, 16, H))``, ``D = 1``, zeros)."""
    device = generator.device if device is None else device
    d_inner, H, N, G, conv_dim = _dims(cfg)
    d, K, pd = cfg.d_model, cfg.conv_kernel, cfg.param_dtype
    in_dim = 2 * d_inner + 2 * G * N + H      # z, x, B, C, dt
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=device).to(pd))
    return nn.ParameterDict({
        "in_proj": dense_init(generator, (d, in_dim), d, pd, device),
        "conv_w": dense_init(generator, (K, conv_dim), K, pd, device),
        "conv_b": zeros_init((conv_dim,), pd, device),
        "A_log": common._param(a_log),
        "D": common._param(torch.ones((H,), dtype=pd, device=device)),
        "dt_bias": zeros_init((H,), pd, device),
        "norm": zeros_init((d_inner,), pd, device),
        "out_proj": dense_init(generator, (d_inner, d), d_inner, pd, device),
    })


class SSMCache(NamedTuple):
    state: torch.Tensor        # (B, H, P, N) fp32
    conv: torch.Tensor         # (B, K-1, conv_dim) trailing raw inputs


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> SSMCache:
    d_inner, H, N, G, conv_dim = _dims(cfg)
    return SSMCache(
        state=torch.zeros((batch, H, cfg.ssm_head_dim, N),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                         dtype=cfg.dtype, device=device),
    )


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d plus bias, then SiLU: xBC (B, L, C)."""
    return F.silu(common.causal_conv(xBC, w) + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): cs_i - cs_j (cs the cumulative sum, so
    sum_{k=j+1..i} a_k) for i >= j, -inf above the diagonal (the
    reference's cumsum-difference form)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,           # (B, L, H, P) — dt-scaled inputs
    a: torch.Tensor,           # (B, L, H)    — dt * A (negative)
    Bm: torch.Tensor,          # (B, L, H, N)
    Cm: torch.Tensor,          # (B, L, H, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
):
    """Returns (y (B, L, H, P), final_state (B, H, P, N))."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    assert L % chunk == 0, (L, chunk)
    c = L // chunk
    xc = x.reshape(Bsz, c, chunk, H, P)
    ac = a.reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)      # (B,H,c,Q)
    Bc = Bm.reshape(Bsz, c, chunk, H, N)
    Cc = Cm.reshape(Bsz, c, chunk, H, N)

    a_cumsum = torch.cumsum(ac, dim=-1)                        # (B,H,c,Q)

    # ---- intra-chunk (dense)
    Lmat = torch.exp(_segsum(ac))                              # (B,H,c,Q,Q)
    y_diag = torch.einsum("bcqhn,bcshn,bhcqs,bcshp->bcqhp",
                          Cc, Bc, Lmat, xc)

    # ---- chunk summaries
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)    # (B,H,c,Q)
    states = torch.einsum("bcqhn,bhcq,bcqhp->bchpn",
                          Bc, decay_states, xc)                # (B,c,H,P,N)

    # ---- inter-chunk linear recurrence:
    #      s_c = exp(sum a in chunk c) * s_{c-1} + states_c
    chunk_decay = torch.exp(a_cumsum[..., -1]).permute(0, 2, 1)   # (B,c,H)
    if initial_state is None:
        initial_state = torch.zeros((Bsz, H, P, N), dtype=x.dtype,
                                    device=x.device)
    aa, bb = common.linear_scan(chunk_decay[..., None, None], states, dim=1)
    # inject the initial state: s_c = aa_c * s0 + bb_c
    s_all = aa * initial_state[:, None] + bb                   # (B,c,H,P,N)
    prev = torch.cat([initial_state[:, None], s_all[:, :-1]], dim=1)
    final_state = s_all[:, -1]

    # ---- chunk-start state contribution
    state_decay = torch.exp(a_cumsum)                          # (B,H,c,Q)
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", Cc, prev, state_decay)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y, final_state


def apply_ssm(
    p,
    x: torch.Tensor,           # (B, L, d_model)
    cfg: ModelConfig,
    cache: Optional[SSMCache] = None,
    decode: bool = False,
):
    """Full mamba2 mixer.  Returns (out (B, L, d), new_cache): the new
    cache is None without ``cache``."""
    d_inner, H, N, G, conv_dim = _dims(cfg)
    P = cfg.ssm_head_dim
    B_, L, _ = x.shape

    zxbcdt = torch.einsum("bld,de->ble", x, p["in_proj"].to(cfg.dtype))
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)

    w = p["conv_w"].to(cfg.dtype)
    cb = p["conv_b"].to(cfg.dtype)
    new_conv = None
    if decode:
        assert cache is not None and L == 1
        window = torch.cat([cache.conv, xBC], dim=1)           # (B, K, C)
        out = torch.einsum("bkc,kc->bc", window, w) + cb
        new_conv = window[:, 1:, :]
        xBC = F.silu(out)[:, None, :]
    else:
        raw = xBC
        xBC = _causal_conv(xBC, w, cb)
        if cache is not None:
            K = cfg.conv_kernel
            new_conv = raw[:, -(K - 1):, :] if L >= K - 1 else torch.cat(
                [cache.conv[:, L:, :], raw], dim=1)

    xr, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xh = xr.reshape(B_, L, H, P)
    Bm = Bm.reshape(B_, L, 1, N).expand(B_, L, H, N)
    Cm = Cm.reshape(B_, L, 1, N).expand(B_, L, H, N)

    A = -torch.exp(p["A_log"].float())                         # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())         # (B,L,H)

    if decode:
        dA = torch.exp(dt[:, 0] * A[None, :])                  # (B,H)
        dx = dt[:, 0, :, None] * xh[:, 0].float()              # (B,H,P)
        state = cache.state * dA[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", dx, Bm[:, 0].float())
        y = torch.einsum("bhpn,bhn->bhp", state, Cm[:, 0].float())
        y = y[:, None]                                         # (B,1,H,P)
        new_state = state
    else:
        a = dt * A[None, None, :]                              # (B,L,H)
        xs = dt[..., None] * xh.float()
        Bm, Cm = Bm.float(), Cm.float()
        pad = (-L) % cfg.ssm_chunk
        if pad:
            xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
            a = F.pad(a, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        init = cache.state if cache is not None else None
        y, new_state = ssd_chunked(xs, a, Bm, Cm, cfg.ssm_chunk, init)
        y = y[:, :L]

    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B_, L, d_inner).to(cfg.dtype)
    y = y * F.silu(z)                                          # gated
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = torch.einsum("ble,ed->bld", y, p["out_proj"].to(cfg.dtype))

    new_cache = (SSMCache(state=new_state, conv=new_conv)
                 if cache is not None else None)
    return out, new_cache
