"""Decoder-only LM assembled from ModelConfig: the dense, moe, ssm,
hybrid and vlm families.  A port of ``repro.models.transformer``.

The reference stacks each segment's repeats and scans over them; the port
holds one ``Block`` module per layer, in the reference's layer order
(``ModelConfig.layer_kinds``), and runs them in a Python loop.  A MoE
config's FFN is ``moe.apply_moe`` except on a ``:dense`` layer
(deepseek-v2's ``first_k_dense``); its auxiliary loss is summed over the
layers, as the reference's scan sums it.  An ``ssm`` layer (mamba2's SSD
mixer, no FFN) or a ``rec`` layer (recurrentgemma's RG-LRU block) keeps
a recurrent state in place of a KV cache (``ssm.SSMCache``,
``rglru.RGLRUCache``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention, common, moe as moe_lib, rglru, ssm
from repro_torch.models.common import ModelConfig, rms_norm, zeros_init


def constrain_batch(x: torch.Tensor, profile: str) -> torch.Tensor:
    """The identity on one device (the LM mesh is ROADMAP item 16f)."""
    return x


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def _split_kind(kind: str):
    mixer, _, ffn_override = kind.partition(":")
    return mixer, ffn_override


class Block(nn.Module):
    """One layer's parameters: ``ln1``, ``mixer``, and, where the config
    has them, ``ln2`` and ``ffn`` and the sandwich norms ``ln1_post`` /
    ``ln2_post`` (the reference's keys)."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind


def init_block(generator, cfg: ModelConfig, kind: str, device=None) -> Block:
    mixer, ffn_override = _split_kind(kind)
    device = generator.device if device is None else device
    d, pd = cfg.d_model, cfg.param_dtype
    p = Block(kind)
    p.ln1 = zeros_init((d,), pd, device)
    if mixer in ("global", "local"):
        p.mixer = attention.init_attention(generator, cfg, device=device)
    elif mixer == "ssm":
        p.mixer = ssm.init_ssm(generator, cfg, device)
    elif mixer == "rec":
        p.mixer = rglru.init_rglru(generator, cfg, device)
    else:
        raise ValueError(f"unknown mixer kind {mixer!r}")

    has_ffn = cfg.d_ff > 0 or cfg.moe
    if has_ffn:
        p.ln2 = zeros_init((d,), pd, device)
        if cfg.moe and ffn_override != "dense":
            p.ffn = moe_lib.init_moe(generator, cfg, device)
        else:
            p.ffn = common.init_mlp(generator, d, cfg.d_ff, cfg,
                                    device=device)
    if cfg.post_norms:
        p.ln1_post = zeros_init((d,), pd, device)
        if has_ffn:
            p.ln2_post = zeros_init((d,), pd, device)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                     device=None):
    mixer, _ = _split_kind(kind)
    if mixer in ("global", "local"):
        if cfg.use_mla:
            return attention.init_mla_cache(cfg, batch, length, device)
        return attention.init_kv_cache(cfg, batch, length, mixer, device)
    if mixer == "ssm":
        return ssm.init_ssm_cache(cfg, batch, device)
    if mixer == "rec":
        return rglru.init_rglru_cache(cfg, batch, device)
    raise ValueError(mixer)


def apply_block(p, x, positions, cfg: ModelConfig, kind: str,
                cache=None, cache_index=None, decode: bool = False):
    """Returns (x, new_cache, aux_loss); aux_loss is 0.0 on a layer
    without a MoE FFN."""
    mixer, ffn_override = _split_kind(kind)
    aux = 0.0

    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if mixer in ("global", "local"):
        out, new_cache = attention.apply_attention(
            p.mixer, h, positions, cfg, kind=mixer, cache=cache,
            cache_index=cache_index)
    elif mixer == "ssm":
        out, new_cache = ssm.apply_ssm(p.mixer, h, cfg, cache=cache,
                                       decode=decode)
    else:
        out, new_cache = rglru.apply_rglru(p.mixer, h, cfg, cache=cache,
                                           decode=decode)
    if cfg.post_norms:
        out = rms_norm(out, p.ln1_post, cfg.norm_eps)
    x = x + out

    if hasattr(p, "ffn"):
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        if cfg.moe and ffn_override != "dense":
            out, aux = moe_lib.apply_moe(p.ffn, h, cfg)
        else:
            out = common.apply_mlp(p.ffn, h, cfg)
        if cfg.post_norms:
            out = rms_norm(out, p.ln2_post, cfg.norm_eps)
        x = x + out
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class DecoderLM(nn.Module):
    """The decoder LM and its parameters: ``embed`` (``table``, and
    ``unembed`` when untied), ``ln_f`` and ``layers``, one ``Block`` per
    layer.  Built uninitialised on ``device`` (default: the GPU; raises
    without one unless ``device`` is given); ``init(generator)`` draws
    every parameter."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._build(None)

    def _build(self, generator):
        cfg, device = self.cfg, self.device
        self.embed = common.init_embed(generator, cfg, device)
        self.ln_f = zeros_init((cfg.d_model,), cfg.param_dtype, device)
        self.layers = nn.ModuleList()
        for kind in cfg.layer_kinds:
            self.layers.append(init_block(generator, cfg, kind, device))

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Draw every parameter from ``generator`` (on this model's device
        type), in place of the old ones; returns the model."""
        self.embed = self.layers = None      # free the old tensors first
        self._build(generator)
        return self

    def init_caches(self, batch: int, length: int):
        """One cache per layer: ``length`` slots for attention (a local
        layer's at most ``window``), a fixed-size state for ``ssm`` and
        ``rec``."""
        return [init_block_cache(self.cfg, kind, batch, length, self.device)
                for kind in self.cfg.layer_kinds]

    # -- forward ------------------------------------------------------------

    def forward(
        self,
        tokens: torch.Tensor,              # (B, L_text)
        positions: torch.Tensor,           # (B, L)
        patch_embeds: Optional[torch.Tensor] = None,   # (B, n_vis, d) vlm
        caches=None,
        cache_index=None,
        decode: bool = False,
    ):
        """Returns (hidden (B, L, d), new_caches, aux): the caches one a
        layer (None without ``caches``), aux the summed MoE auxiliary loss
        (0.0 without MoE)."""
        cfg = self.cfg
        x = common.embed_tokens(self.embed, tokens, cfg)
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(cfg.dtype), x], dim=1)
        x = constrain_batch(x, cfg.sharding_profile)
        aux_total = 0.0
        new_caches = []
        for i, block in enumerate(self.layers):
            cache_i = caches[i] if caches is not None else None
            x, nc, aux_i = apply_block(
                block, x, positions, cfg, block.kind, cache=cache_i,
                cache_index=cache_index, decode=decode)
            x = constrain_batch(x, cfg.sharding_profile)
            new_caches.append(nc)
            aux_total = aux_total + aux_i
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        return x, (new_caches if caches is not None else None), aux_total

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return common.unembed(self.embed, hidden, self.cfg)
