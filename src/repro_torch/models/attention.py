"""Attention layers: GQA/MQA with rotary, sliding-window (local) masks,
attention-logit softcap (gemma2), per-head qk-norm (qwen3), MLA latent
attention (deepseek-v2) with both the expanded and the absorbed decode,
and cross attention (whisper), each with a cache for serving.  A port of
``repro.models.attention``.

The arithmetic is the reference's in plain torch: einsum, an additive fp32
mask computed from positions, the softcap, then a softmax (short keys and
decode) or an online softmax over key blocks (``_sdpa_flash``).
``F.scaled_dot_product_attention`` has no logit softcap and takes no
position-computed masks, so it is not used.

Cache layout (global layers): k/v (B, S_cache, KV, hd) and the position of
each slot (-1 empty).  A local layer keeps a ring buffer of
``S = min(length, window)`` slots and every key at slot ``position % S``,
at prefill and at decode alike; one shorter than the window grows into
the full ring when decode reaches its end, so a local layer sets no limit
on decode.  (The reference's prefill keeps the
trailing window in slots 0..S-1 instead, which its decode's ``p % S``
agrees with only when the prompt length is at most S or a multiple of it;
ROADMAP.md queue 3.)  MLA caches the latent (B, S, kv_lora) and the
shared rope key (B, S, rope_hd) instead of per-head k/v.  Caches are
written in place and returned.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.common import (
    ModelConfig, dense_init, rms_norm, rope, softcap, zeros_init)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator, cfg: ModelConfig, cross: bool = False,
                   device=None) -> nn.ParameterDict:
    if cfg.use_mla and not cross:
        return _init_mla(generator, cfg, device)
    hd, d, pd = cfg.head_dim_, cfg.d_model, cfg.param_dtype
    p = nn.ParameterDict({
        "wq": dense_init(generator, (d, cfg.n_heads, hd), d, pd, device),
        "wk": dense_init(generator, (d, cfg.n_kv_heads, hd), d, pd, device),
        "wv": dense_init(generator, (d, cfg.n_kv_heads, hd), d, pd, device),
        "wo": dense_init(generator, (cfg.n_heads, hd, d), cfg.n_heads * hd,
                         pd, device),
    })
    if cfg.qk_norm:
        device = generator.device if device is None else device
        p["q_norm"] = zeros_init((hd,), pd, device)
        p["k_norm"] = zeros_init((hd,), pd, device)
    return p


def _init_mla(generator, cfg: ModelConfig, device=None):
    device = generator.device if device is None else device
    nope, rh, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H, d, r, pd = cfg.n_heads, cfg.d_model, cfg.kv_lora_rank, cfg.param_dtype
    p = nn.ParameterDict({
        "w_dkv": dense_init(generator, (d, r), d, pd, device),
        "w_krope": dense_init(generator, (d, rh), d, pd, device),
        "kv_norm": zeros_init((r,), pd, device),
        "w_uk": dense_init(generator, (r, H, nope), r, pd, device),
        "w_uv": dense_init(generator, (r, H, vh), r, pd, device),
        "wo": dense_init(generator, (H, vh, d), H * vh, pd, device),
    })
    if cfg.q_lora_rank:
        qr = cfg.q_lora_rank
        p["w_dq"] = dense_init(generator, (d, qr), d, pd, device)
        p["q_norm"] = zeros_init((qr,), pd, device)
        p["w_uq"] = dense_init(generator, (qr, H, nope + rh), qr, pd, device)
    else:
        p["w_uq"] = dense_init(generator, (d, H, nope + rh), d, pd, device)
    return p


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def make_mask(
    q_pos: torch.Tensor,       # (B, Lq) positions of queries
    kv_pos: torch.Tensor,      # (B, Lk) positions of keys (-1 = empty slot)
    kind: str,                 # 'global' | 'local'
    window: int,
    causal: bool = True,
) -> torch.Tensor:
    """(B, 1, Lq, Lk) additive fp32 mask."""
    dq = q_pos[:, :, None]
    dk = kv_pos[:, None, :]
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if kind == "local":
        ok = ok & ((dq - dk) < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)[:, None, :, :]


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _sdpa_dense(q, k, v, mask, cfg: ModelConfig, scale: float):
    """Reference GQA attention, full (Lq, Lk) logits.  Used for short
    sequences and decode (Lq=1).  Query head ``h`` reads kv head
    ``h // G``."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Lq, KV, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    logits = softcap(logits, cfg.attn_softcap)
    logits = logits + mask[:, :, None, :, :]        # mask (B,1,Lq,Lk)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Lq, H, v.shape[-1]).to(cfg.dtype)


# Block sizes of the memory-efficient path: live logits per block are
# (B, H, Q_BLOCK, KV_BLOCK) instead of (B, H, Lq, Lk), and masks are
# computed blockwise from positions, never materialised at (Lq, Lk).
# Module attributes read at call time, so a test can shrink them.
Q_BLOCK = 512
KV_BLOCK = 1024
_DENSE_MAX = 2048       # below this KV length the dense path is cheaper


def _sdpa_flash(q, k, v, q_pos, kv_pos, kind, causal, cfg: ModelConfig,
                scale: float):
    """FlashAttention-style two-level blocking in plain torch: a loop over
    query blocks, and within it an online softmax over key blocks.  The
    same math as ``_sdpa_dense``.  The last block of either axis is
    ragged; the reference pads it with masked rows and columns, whose
    weights are exactly zero."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Lk = k.shape[1]
    hv = v.shape[-1]
    CQ = min(Q_BLOCK, Lq)
    CK = min(KV_BLOCK, Lk)

    outs = []
    for q0 in range(0, Lq, CQ):
        qb = q[:, q0:q0 + CQ]
        cq = qb.shape[1]
        qr = qb.reshape(B, cq, KV, G, hd).float()
        qpb = q_pos[:, q0:q0 + CQ]
        acc = torch.zeros((B, KV, G, cq, hv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, G, cq), -1e30, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((B, KV, G, cq), dtype=torch.float32,
                            device=q.device)
        for k0 in range(0, Lk, CK):
            kb = k[:, k0:k0 + CK].float()
            vb = v[:, k0:k0 + CK].float()
            logits = torch.einsum("bqkgh,bskh->bkgqs", qr, kb) * scale
            logits = softcap(logits, cfg.attn_softcap)
            mb = make_mask(qpb, kv_pos[:, k0:k0 + CK], kind, cfg.window,
                           causal)                           # (B,1,cq,ck)
            logits = logits + mb[:, :, None, :, :]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # guard fully-masked rows: keep m finite
            m_new = torch.clamp_min(m_new, -1e30)
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vb)
            m = m_new
        out = acc / torch.clamp_min(denom, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, hv)
                    .to(cfg.dtype))
    return torch.cat(outs, dim=1)


def _sdpa_positions(q, k, v, q_pos, kv_pos, kind, causal,
                    cfg: ModelConfig, scale: float):
    """Dispatch on shape: flash blocking for long non-decode shapes, dense
    (with a materialised mask) otherwise."""
    if q.shape[1] > 1 and k.shape[1] > _DENSE_MAX:
        return _sdpa_flash(q, k, v, q_pos, kv_pos, kind, causal, cfg, scale)
    mask = make_mask(q_pos, kv_pos, kind, cfg.window, causal)
    return _sdpa_dense(q, k, v, mask, cfg, scale)


# ---------------------------------------------------------------------------
# standard (GQA) attention with cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor            # (B, S, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor          # (B, S) position of each slot; -1 empty


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, kind: str,
                  device=None) -> KVCache:
    if kind == "local":
        length = min(length, cfg.window)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
    )


def project_cross_kv(p, kv: torch.Tensor, kv_pos: torch.Tensor,
                     cfg: ModelConfig) -> KVCache:
    """Precompute cross-attention k/v once (prefill); decode reuses them."""
    k = torch.einsum("bld,dnh->blnh", kv, p["wk"].to(cfg.dtype))
    v = torch.einsum("bld,dnh->blnh", kv, p["wv"].to(cfg.dtype))
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return KVCache(k=k, v=v, pos=kv_pos.to(torch.int32))


def _grow_ring(cache: KVCache, window: int) -> KVCache:
    """A local layer's cache of ``S < window`` slots, each key at slot =
    its position (as prefill and decode fill it: a prompt plus
    ``GEN_MARGIN`` shorter than the window), padded with empty slots to a
    full ring of ``window``: the same keys at ``position % window``."""
    B, S = cache.pos.shape
    pad = (B, window - S)
    return KVCache(
        k=torch.cat([cache.k, cache.k.new_zeros(pad + cache.k.shape[2:])], 1),
        v=torch.cat([cache.v, cache.v.new_zeros(pad + cache.v.shape[2:])], 1),
        pos=torch.cat([cache.pos, cache.pos.new_full(pad, -1)], 1))


def _write_decode(cache: KVCache, k, v, positions, kind, cache_index,
                  window):
    """Write one decode step's keys at slot ``cache_index``, or
    ``cache_index % S`` in a local layer's full ring (S = window).  A
    local layer's cache shorter than the window grows into the full ring
    when decode reaches its end (the reference's ``p % S`` wraps it onto
    keys still inside the window; ROADMAP.md queue 3).  A slot past a
    global layer's cache raises: the reference's ``dynamic_update_slice``
    clamps it onto the last slot, overwriting a live key."""
    S = cache.k.shape[1]
    index = int(cache_index)
    L = k.shape[1]
    if kind == "local" and S < window and index + L > S:
        cache = _grow_ring(cache, window)
        S = window
    slot = index % S if kind == "local" and S >= window else index
    if slot + L > S:
        raise ValueError(
            f"decode position {index} falls past the KV cache's {S} slots: "
            "prefill leaves DecoderTask.GEN_MARGIN free slots for decode, "
            "so generate at most GEN_MARGIN + 1 tokens")
    cache.k[:, slot:slot + L] = k
    cache.v[:, slot:slot + L] = v
    cache.pos[:, slot:slot + L] = positions.to(torch.int32)
    return cache


def _write_prefill(cache: KVCache, k, v, positions, kind):
    """Write the prompt's keys: a global layer's at slots 0..L-1, a local
    layer's last ``min(L, S)`` at slots ``position % S``."""
    L = k.shape[1]
    S = cache.k.shape[1]
    if kind == "local":
        keep = min(L, S)
        slots = (positions[:, L - keep:] % S).long()          # (B, keep)
        idx = slots[:, :, None, None].expand(-1, -1, *k.shape[2:])
        cache.k.scatter_(1, idx, k[:, L - keep:])
        cache.v.scatter_(1, idx, v[:, L - keep:])
        cache.pos.scatter_(1, slots, positions[:, L - keep:].to(torch.int32))
        return cache
    if L > S:
        raise ValueError(f"a prompt of {L} positions exceeds the KV "
                         f"cache's {S} slots")
    cache.k[:, :L] = k
    cache.v[:, :L] = v
    cache.pos[:, :L] = positions.to(torch.int32)
    return cache


def apply_attention(
    p,
    x: torch.Tensor,           # (B, L, d)
    positions: torch.Tensor,   # (B, L)
    cfg: ModelConfig,
    kind: str = "global",      # 'global' | 'local'
    cache: Optional[KVCache] = None,
    cache_index=None,          # the slot position to write (decode): int
    kv: Optional[torch.Tensor] = None,         # cross-attention memory
    kv_pos: Optional[torch.Tensor] = None,
    cross_cache: Optional[KVCache] = None,     # precomputed cross k/v
    causal: bool = True,
):
    """Returns (out, new_cache)."""
    if cfg.use_mla and kv is None and cross_cache is None:
        return apply_mla(p, x, positions, cfg, cache, cache_index)
    hd = cfg.head_dim_
    scale = 1.0 / math.sqrt(hd)
    q = torch.einsum("bld,dnh->blnh", x, p["wq"].to(cfg.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)

    if cross_cache is not None:
        # cross attention against precomputed encoder k/v — no cache update
        out = _sdpa_positions(q, cross_cache.k, cross_cache.v, positions,
                              cross_cache.pos, "global", False, cfg, scale)
        return _proj_out(p, out, cfg), None

    src = x if kv is None else kv
    k = torch.einsum("bld,dnh->blnh", src, p["wk"].to(cfg.dtype))
    v = torch.einsum("bld,dnh->blnh", src, p["wv"].to(cfg.dtype))
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if kv is None:             # self-attention: rope
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        if cache_index is not None:
            # decode: attend over the whole (ring) buffer after the write
            new_cache = _write_decode(cache, k, v, positions, kind,
                                      cache_index, cfg.window)
            out = _sdpa_positions(q, new_cache.k, new_cache.v, positions,
                                  new_cache.pos, kind, causal, cfg, scale)
            return _proj_out(p, out, cfg), new_cache
        # prefill: attention runs over the fresh k/v, not the cache
        new_cache = _write_prefill(cache, k, v, positions, kind)

    if kv is None:
        out = _sdpa_positions(q, k, v, positions, positions, kind, causal,
                              cfg, scale)
    else:
        out = _sdpa_positions(q, k, v, positions, kv_pos, "global", False,
                              cfg, scale)
    return _proj_out(p, out, cfg), new_cache


def _proj_out(p, out, cfg):
    return torch.einsum("blnh,nhd->bld", out, p["wo"].to(cfg.dtype))


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor         # (B, S, kv_lora)
    k_rope: torch.Tensor       # (B, S, rope_hd)
    pos: torch.Tensor          # (B, S) position of each slot; -1 empty


def init_mla_cache(cfg: ModelConfig, batch: int, length: int,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, length, cfg.kv_lora_rank), dtype=cfg.dtype,
                         device=device),
        k_rope=torch.zeros((batch, length, cfg.qk_rope_head_dim),
                           dtype=cfg.dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device),
    )


def _write_mla(cache: MLACache, c_kv, k_rope, positions, slot: int,
               decode: bool) -> MLACache:
    """Write ``L`` steps' latents at slots ``slot..slot+L-1`` (the prompt
    at 0, a decode step at its position).  A slot past the cache raises:
    the reference's ``dynamic_update_slice`` clamps it onto the last
    slots, overwriting live latents."""
    S, L = cache.c_kv.shape[1], c_kv.shape[1]
    if slot + L > S:
        if decode:
            raise ValueError(
                f"decode position {slot} falls past the MLA cache's {S} "
                "slots: prefill leaves DecoderTask.GEN_MARGIN free slots "
                "for decode, so generate at most GEN_MARGIN + 1 tokens")
        raise ValueError(f"a prompt of {L} positions exceeds the MLA "
                         f"cache's {S} slots")
    cache.c_kv[:, slot:slot + L] = c_kv
    cache.k_rope[:, slot:slot + L] = k_rope
    cache.pos[:, slot:slot + L] = positions.to(torch.int32)
    return cache


def _mla_q(p, x, cfg: ModelConfig):
    if cfg.q_lora_rank:
        cq = torch.einsum("bld,dr->blr", x, p["w_dq"].to(cfg.dtype))
        cq = rms_norm(cq, p["q_norm"], cfg.norm_eps)
        q = torch.einsum("blr,rnh->blnh", cq, p["w_uq"].to(cfg.dtype))
    else:
        q = torch.einsum("bld,dnh->blnh", x, p["w_uq"].to(cfg.dtype))
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = q[..., cfg.qk_nope_head_dim:]
    return q_nope, q_rope


def apply_mla(p, x, positions, cfg: ModelConfig,
              cache: Optional[MLACache] = None, cache_index=None):
    """DeepSeek-V2 multi-head latent attention.  Returns (out, new_cache).

    Prefill and the teacher-forced forward expand the latent to per-head
    keys and values (the standard path): the shared rope key is
    concatenated onto every head's key, so the q/k head dim (nope + rope)
    is not v's, and the dense or flash core reads v's.  Decode with
    ``cfg.mla_absorb`` folds ``w_uk`` into the queries and ``w_uv`` into
    the output, attending against the (B, S, r) latent cache directly."""
    nope, rh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(nope + rh)

    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    c_kv = torch.einsum("bld,dr->blr", x, p["w_dkv"].to(cfg.dtype))
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = torch.einsum("bld,dh->blh", x, p["w_krope"].to(cfg.dtype))
    k_rope = rope(k_rope, positions, cfg.rope_theta)

    new_cache = None
    kpos = positions
    if cache is not None:
        decode = cache_index is not None
        new_cache = _write_mla(cache, c_kv, k_rope, positions,
                               int(cache_index) if decode else 0, decode)
        if decode:       # attend over the whole cache after the write
            c_kv, k_rope, kpos = new_cache

    if cfg.mla_absorb and cache_index is not None:
        mask = make_mask(positions, kpos, "global", cfg.window, causal=True)
        q_lat = torch.einsum("blnh,rnh->blnr", q_nope,
                             p["w_uk"].to(cfg.dtype))            # (B,L,H,r)
        logits = (
            torch.einsum("blnr,bsr->bnls", q_lat.float(), c_kv.float())
            + torch.einsum("blnh,bsh->bnls", q_rope.float(), k_rope.float())
        ) * scale
        logits = softcap(logits, cfg.attn_softcap) + mask
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bnls,bsr->blnr", w, c_kv.float())
        out = torch.einsum("blnr,rnh->blnh", ctx.to(cfg.dtype),
                           p["w_uv"].to(cfg.dtype))
    else:
        k_nope = torch.einsum("bsr,rnh->bsnh", c_kv, p["w_uk"].to(cfg.dtype))
        v = torch.einsum("bsr,rnh->bsnh", c_kv, p["w_uv"].to(cfg.dtype))
        k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            -1, -1, cfg.n_heads, -1)], dim=-1)
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        out = _sdpa_positions(q_cat, k_cat, v, positions, kpos, "global",
                              True, cfg, scale)

    out = torch.einsum("blnh,nhd->bld", out.to(cfg.dtype),
                       p["wo"].to(cfg.dtype))
    return out, new_cache
