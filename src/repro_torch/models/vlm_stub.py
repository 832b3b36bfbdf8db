"""VLM frontend STUB (llava-next anyres tiling).  A port of
``repro.models.vlm_stub``.

The [vlm] entries specify the transformer BACKBONE only; the modality
frontend supplies precomputed patch embeddings, prepended to the text.
Real anyres tiling (llava-1.6): the image is split into up to 5 tiles
(best-fit aspect grid + a downscaled overview), each encoded by CLIP-ViT-L
336px -> 24x24 = 576 patch embeddings, then projected to d_model by a
2-layer MLP.  5 x 576 = 2880 = ModelConfig.vision_tokens.
"""
from __future__ import annotations

import torch


def synthetic_patch_embeds(generator: torch.Generator, batch: int,
                           n_tokens: int, d_model: int,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Stand-in for the frozen vision tower's projected output, drawn from
    ``generator`` on its device."""
    x = torch.empty((batch, n_tokens, d_model), dtype=torch.float32,
                    device=generator.device)
    return (x.normal_(generator=generator) * 0.02).to(dtype)
