"""Uniform Task API over the LM zoo, and the assigned shape cells.  A port
of ``repro.models.registry``'s serving half.

A Task exposes:
  * ``prefill(params, batch) -> (caches, logits)``
  * ``decode_step(params, batch, caches) -> (logits, caches)``

``params`` is the ``DecoderLM`` that ``init`` returns: the port's
parameters live in the module.  Both run without autograd.  ``loss`` (LM
training) is ROADMAP item 16e, ``input_specs`` (the dry-run's stand-ins)
16f, and the encoder-decoder task 16d.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import DecoderLM
from repro_torch.util import not_ported


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                  # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train", 4096, 256),
    "prefill_32k": ShapeCell("prefill", 32768, 32),
    "decode_32k": ShapeCell("decode", 32768, 128),
    "long_500k": ShapeCell("decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing);
# pure full-attention archs skip it
SUBQUADRATIC = ("mamba2-130m", "recurrentgemma-9b")


def cell_is_applicable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in SUBQUADRATIC
    return True


# ---------------------------------------------------------------------------
# decoder-only task (dense / moe / ssm / hybrid / vlm)
# ---------------------------------------------------------------------------

class DecoderTask:
    """The decoder-only task on ``device`` (default: the GPU; raises
    without one unless ``device`` is given)."""

    # cache headroom prefill leaves for subsequent decode steps
    GEN_MARGIN = 64

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = None

    def init(self, generator: torch.Generator) -> DecoderLM:
        """A ``DecoderLM`` on the task's device, every parameter drawn
        from ``generator`` (a generator of that device's type)."""
        self.model = DecoderLM(self.cfg, self.device).init(generator)
        return self.model

    # -- train --------------------------------------------------------------

    def loss(self, params, batch):
        raise not_ported("DecoderTask.loss (LM training)", "16e")

    # -- serve --------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params: DecoderLM, batch):
        """Run the prompt, returning caches (an attention layer's with
        GEN_MARGIN free slots; an ``ssm`` or ``rec`` layer's fixed-size
        state has no slot limit) and the last position's logits
        (B, 1, V)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        patch = batch.get("patch_embeds")
        B, Lt = tokens.shape
        n_vis = patch.shape[1] if patch is not None else 0
        L = Lt + n_vis
        positions = torch.arange(L, dtype=torch.int32,
                                 device=self.device)[None].expand(B, L)
        caches = params.init_caches(B, L + self.GEN_MARGIN)
        hidden, caches, _ = params.forward(
            tokens, positions, patch_embeds=patch, caches=caches)
        logits = params.logits(hidden[:, -1:])
        return caches, logits

    @torch.no_grad()
    def decode_step(self, params: DecoderLM, batch, caches):
        """One token with an existing cache.  batch: tokens (B, 1), pos (a
        Python int: the slot index, checked on the host).  Raises
        ``ValueError`` where ``pos`` falls past a global attention
        layer's cache."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        pos = int(batch["pos"])
        B = tokens.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=self.device)
        hidden, caches, _ = params.forward(
            tokens, positions, caches=caches, cache_index=pos, decode=True)
        return params.logits(hidden), caches

    # -- specs --------------------------------------------------------------

    def input_specs(self, shape_name: str):
        raise not_ported("DecoderTask.input_specs (the dry-run)", "16f")


def make_task(cfg: ModelConfig, device=None) -> DecoderTask:
    if cfg.encoder_decoder:
        raise not_ported(f"{cfg.name}: the encoder-decoder task", "16d")
    return DecoderTask(cfg, device)
