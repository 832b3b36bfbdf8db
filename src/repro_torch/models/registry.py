"""Uniform Task API over the LM zoo, and the assigned shape cells.  A port
of ``repro.models.registry``.

A Task exposes:
  * ``loss(params, batch)`` -> the training loss, an fp32 scalar with an
    autograd graph through ``params``
  * ``prefill(params, batch) -> (caches, logits)``
  * ``decode_step(params, batch, caches) -> (logits, caches)``

``params`` is the module that ``init`` returns (a ``DecoderLM``, or an
``EncDecLM`` for the encoder-decoder task): the port's parameters live in
the module.  ``prefill`` and ``decode_step`` run without autograd.
``input_specs(shape_name)`` gives a stand-in for every input of a shape
cell as tensors on the ``meta`` device (shape and dtype, no storage), the
reference's ``ShapeDtypeStruct``s: what the dry-run traces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.train import losses

AUX_COEF = 0.01


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

    def loss(self, params: DecoderLM, batch) -> torch.Tensor:
        """The mean next-token cross entropy over the text positions plus
        ``AUX_COEF`` times the summed MoE auxiliary loss.  batch: tokens
        (B, L) and, for a vlm config, patch_embeds (B, n_vis, d)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        patch = batch.get("patch_embeds")
        if patch is not None:
            patch = torch.as_tensor(patch, device=self.device)
        B, Lt = tokens.shape
        n_vis = patch.shape[1] if patch is not None else 0
        L = Lt + n_vis
        positions = torch.arange(L, dtype=torch.int32,
                                 device=self.device)[None].expand(B, L)
        hidden, _, aux = params.forward(tokens, positions,
                                        patch_embeds=patch)
        labels = losses.shift_labels(tokens)
        ce = losses.chunked_cross_entropy(
            hidden[:, n_vis:], labels, params.logits,
            chunk=self.cfg.ce_chunk)
        return ce + AUX_COEF * aux

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
        """{"batch": ...} (and, for a decode cell, "caches": one per
        layer, from ``init_caches``) as ``meta`` tensors."""
        cfg = self.cfg
        cell = SHAPES[shape_name]
        n_vis = cfg.vision_tokens
        if cell.kind in ("train", "prefill"):
            batch = {"tokens": _meta((cell.batch, cell.seq - n_vis),
                                     torch.int32)}
            if n_vis:
                batch["patch_embeds"] = _meta(
                    (cell.batch, n_vis, cfg.d_model), cfg.dtype)
            return {"batch": batch}
        batch = {"tokens": _meta((cell.batch, 1), torch.int32),
                 "pos": _meta((), torch.int32)}
        caches = DecoderLM(cfg, "meta").init_caches(cell.batch, cell.seq)
        return {"batch": batch, "caches": caches}


# ---------------------------------------------------------------------------
# encoder-decoder task (whisper)
# ---------------------------------------------------------------------------

class EncDecTask:
    """The encoder-decoder task on ``device`` (default: the GPU; raises
    without one unless ``device`` is given).  batch: frames (B, S, d),
    the post-conv audio embeddings, and tokens (B, L)."""

    # cache headroom prefill leaves for subsequent decode steps (the
    # reference's literal 64)
    GEN_MARGIN = 64

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = None

    def init(self, generator: torch.Generator) -> EncDecLM:
        """An ``EncDecLM`` on the task's device, every parameter drawn
        from ``generator`` (a generator of that device's type)."""
        self.model = EncDecLM(self.cfg, self.device).init(generator)
        return self.model

    def _inputs(self, batch):
        frames = torch.as_tensor(batch["frames"], device=self.device)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, L = tokens.shape
        positions = torch.arange(L, dtype=torch.int32,
                                 device=self.device)[None].expand(B, L)
        return frames, tokens, positions

    def loss(self, params: EncDecLM, batch) -> torch.Tensor:
        """The mean next-token cross entropy of the decoder, teacher
        forced against the encoded frames."""
        frames, tokens, positions = self._inputs(batch)
        memory = params.encode(frames)
        hidden, _ = params.decode_stack(tokens, positions, memory)
        return losses.chunked_cross_entropy(
            hidden, losses.shift_labels(tokens), params.logits,
            chunk=self.cfg.ce_chunk)

    @torch.no_grad()
    def prefill(self, params: EncDecLM, batch):
        """Encode the frames, project every layer's cross k/v once, and
        run the prompt into self-KV caches of ``L + GEN_MARGIN`` slots;
        returns (caches, the last position's logits (B, 1, V))."""
        frames, tokens, positions = self._inputs(batch)
        memory = params.encode(frames)
        caches = params.init_caches(memory,
                                    tokens.shape[1] + self.GEN_MARGIN)
        hidden, caches = params.decode_stack(tokens, positions,
                                             caches=caches)
        return caches, params.logits(hidden[:, -1:])

    @torch.no_grad()
    def decode_step(self, params: EncDecLM, batch, caches):
        """One token with existing caches.  batch: tokens (B, 1), pos (a
        Python int, checked on the host).  Raises ``ValueError`` where
        ``pos`` falls past the self-KV cache."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        pos = int(batch["pos"])
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=self.device)
        hidden, caches = params.decode_stack(tokens, positions,
                                             caches=caches, cache_index=pos)
        return params.logits(hidden), caches

    def input_specs(self, shape_name: str):
        """{"batch": ...} (and, for a decode cell, "caches": the self-KV
        caches of the cell's length and the cross k/v over an encoder
        memory of ``min(seq, 4 * decoder_len)`` frames) as ``meta``
        tensors."""
        cfg = self.cfg
        cell = SHAPES[shape_name]
        if cell.kind in ("train", "prefill"):
            return {"batch": {
                "frames": _meta((cell.batch, cell.seq, cfg.d_model),
                                cfg.dtype),
                "tokens": _meta((cell.batch, cfg.decoder_len), torch.int32),
            }}
        batch = {"tokens": _meta((cell.batch, 1), torch.int32),
                 "pos": _meta((), torch.int32)}
        memory = _meta((cell.batch, min(cell.seq, 4 * cfg.decoder_len),
                        cfg.d_model), cfg.dtype)
        with torch.no_grad():
            caches = EncDecLM(cfg, "meta").init_caches(memory, cell.seq)
        return {"batch": batch, "caches": caches}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_task(cfg: ModelConfig, device=None):
    return EncDecTask(cfg, device) if cfg.encoder_decoder else \
        DecoderTask(cfg, device)
