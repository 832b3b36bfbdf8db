"""Encoder-decoder transformer (the Whisper backbone, arXiv:2212.04356).
A port of ``repro.models.encdec``.

The conv frontend is a stub, as in the reference: the caller supplies
post-conv audio frame embeddings (B, S_audio, d_model); this module adds
sinusoidal positions and runs the encoder stack.  The decoder is a causal
transformer with cross attention; decode uses a self-attention KV cache
plus the cross-attention k/v, projected once at prefill.

Whisper uses LayerNorm (scale and bias) and plain-GELU MLPs, kept here as
in the reference.  The reference stacks each stack's layers and scans over
them; the port holds one module per layer (``EncDecLM.enc``, ``.dec``) and
runs them in a Python loop, each under ``torch.utils.checkpoint`` where
``cfg.remat`` is set and autograd records (the reference's
``jax.checkpoint`` of the scan body).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention, common
from repro_torch.models.common import (
    ModelConfig, layer_norm, ones_init, sinusoidal_at, sinusoidal_positions,
    zeros_init)
from repro_torch.parallel import util as par
from repro_torch.parallel.util import constrain_batch


def _init_ln(cfg: ModelConfig, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": ones_init((cfg.d_model,), cfg.param_dtype, device),
        "bias": zeros_init((cfg.d_model,), cfg.param_dtype, device)})


def _ln(p, x, cfg: ModelConfig):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


class EncBlock(nn.Module):
    """One encoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""


class DecBlock(nn.Module):
    """One decoder layer: ``ln1``, ``self_attn``, ``ln_x``,
    ``cross_attn``, ``ln2``, ``mlp``."""


def init_enc_block(generator, cfg: ModelConfig, device=None) -> EncBlock:
    device = generator.device if device is None else device
    p = EncBlock()
    p.ln1 = _init_ln(cfg, device)
    p.attn = attention.init_attention(generator, cfg, device=device)
    p.ln2 = _init_ln(cfg, device)
    p.mlp = common.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg,
                            gated=False, device=device)
    return p


def init_dec_block(generator, cfg: ModelConfig, device=None) -> DecBlock:
    device = generator.device if device is None else device
    p = DecBlock()
    p.ln1 = _init_ln(cfg, device)
    p.self_attn = attention.init_attention(generator, cfg, device=device)
    p.ln_x = _init_ln(cfg, device)
    p.cross_attn = attention.init_attention(generator, cfg, cross=True,
                                            device=device)
    p.ln2 = _init_ln(cfg, device)
    p.mlp = common.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg,
                            gated=False, device=device)
    return p


class DecCache(NamedTuple):
    self_kv: attention.KVCache
    cross_kv: attention.KVCache        # precomputed encoder k/v


def _enc_block(p: EncBlock, x, positions, cfg: ModelConfig):
    h = _ln(p.ln1, x, cfg)
    out, _ = attention.apply_attention(p.attn, h, positions, cfg,
                                       kind="global", causal=False)
    x = x + out
    h = _ln(p.ln2, x, cfg)
    x = x + common.apply_mlp(p.mlp, h, cfg)
    return constrain_batch(x, cfg.sharding_profile)


def _dec_block(p: DecBlock, x, positions, cfg: ModelConfig, memory=None,
               mem_pos=None, cache: Optional[DecCache] = None,
               cache_index=None):
    """Returns (x, new_cache); new_cache is None without ``cache``."""
    h = _ln(p.ln1, x, cfg)
    out, new_self = attention.apply_attention(
        p.self_attn, h, positions, cfg, kind="global",
        cache=None if cache is None else cache.self_kv,
        cache_index=cache_index)
    x = x + out
    h = _ln(p.ln_x, x, cfg)
    if cache is not None:
        out, _ = attention.apply_attention(p.cross_attn, h, positions, cfg,
                                           cross_cache=cache.cross_kv)
    else:
        out, _ = attention.apply_attention(p.cross_attn, h, positions, cfg,
                                           kv=memory, kv_pos=mem_pos,
                                           causal=False)
    x = x + out
    h = _ln(p.ln2, x, cfg)
    x = x + common.apply_mlp(p.mlp, h, cfg)
    x = constrain_batch(x, cfg.sharding_profile)
    return x, (None if cache is None else DecCache(new_self, cache.cross_kv))


def _local(fn, block, *args, **kw):
    with par.local_params(block):
        return fn(block, *args, **kw)


def _memory_positions(memory: torch.Tensor) -> torch.Tensor:
    B, S = memory.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=memory.device)[None].expand(B, S)


class EncDecLM(nn.Module):
    """The encoder-decoder LM and its parameters: ``embed`` (tied),
    ``enc`` and ``dec`` (one block a layer), ``ln_enc`` and ``ln_dec``.
    Built uninitialised on ``device`` (default: the GPU; raises without
    one unless ``device`` is given); ``init(generator)`` draws every
    parameter."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._build(None)

    def _build(self, generator):
        cfg, device = self.cfg, self.device
        self.embed = common.init_embed(generator, cfg, device)
        self.enc = nn.ModuleList(
            init_enc_block(generator, cfg, device)
            for _ in range(cfg.n_encoder_layers))
        self.dec = nn.ModuleList(
            init_dec_block(generator, cfg, device)
            for _ in range(cfg.n_layers))
        self.ln_enc = _init_ln(cfg, device)
        self.ln_dec = _init_ln(cfg, device)

    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Draw every parameter from ``generator`` (on this model's device
        type), in place of the old ones; returns the model."""
        self.embed = self.enc = self.dec = None    # free the old tensors
        self._build(generator)
        return self

    def _remat(self, fn, *args, **kw):
        """``fn(block, ...)`` on the block's local parameters, under
        ``torch.utils.checkpoint`` where ``cfg.remat`` is set and autograd
        records."""
        if self.cfg.remat and torch.is_grad_enabled():
            return par.remat(_local, fn, *args, **kw)
        return _local(fn, *args, **kw)

    # -- encoder ------------------------------------------------------------

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S, d) post-conv embeddings (the frontend stub).
        Returns the encoder output (B, S, d) in ``cfg.dtype``."""
        cfg = self.cfg
        B, S, _ = frames.shape
        pos_emb = sinusoidal_positions(S, cfg.d_model,
                                       frames.device).to(cfg.dtype)
        x = frames.to(cfg.dtype) + pos_emb[None]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=frames.device)[None].expand(B, S)
        for block in self.enc:
            x = self._remat(_enc_block, block, x, positions, cfg)
        with par.local_params(self.ln_enc):
            return _ln(self.ln_enc, x, cfg)

    # -- decoder ------------------------------------------------------------

    def decode_stack(self, tokens: torch.Tensor, positions: torch.Tensor,
                     memory: Optional[torch.Tensor] = None,
                     caches: Optional[List[DecCache]] = None,
                     cache_index=None):
        """tokens (B, L); memory (B, S, d) the encoder output (None when
        serving from caches).  Returns (hidden, new_caches): the caches
        one a layer, None without ``caches``."""
        cfg = self.cfg
        with par.local_params(self.embed):
            x = common.embed_tokens(self.embed, tokens, cfg)
        x = x + sinusoidal_at(positions, cfg.d_model).to(cfg.dtype)
        mem_pos = None if memory is None else _memory_positions(memory)
        new_caches = []
        for i, block in enumerate(self.dec):
            cache = caches[i] if caches is not None else None
            if cache is None:
                x, _ = self._remat(_dec_block, block, x, positions, cfg,
                                   memory, mem_pos)
            else:
                x, nc = _local(_dec_block, block, x, positions, cfg,
                               cache=cache, cache_index=cache_index)
                new_caches.append(nc)
        with par.local_params(self.ln_dec):
            x = _ln(self.ln_dec, x, cfg)
        return x, (new_caches if caches is not None else None)

    def init_caches(self, memory: torch.Tensor,
                    length: int) -> List[DecCache]:
        """The decoder's caches: an empty self-KV cache of ``length`` slots
        and the cross k/v projected from ``memory``, one a layer."""
        cfg = self.cfg
        B = memory.shape[0]
        mem_pos = _memory_positions(memory)
        out = []
        for block in self.dec:
            with par.local_params(block.cross_attn):
                out.append(DecCache(
                    attention.init_kv_cache(cfg, B, length, "global",
                                            self.device),
                    attention.project_cross_kv(block.cross_attn, memory,
                                               mem_pos, cfg)))
        return out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        with par.local_params(self.embed):
            return common.unembed(self.embed, hidden, self.cfg)
