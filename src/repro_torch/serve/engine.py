"""Batched LM serving engine: prefill + greedy/temperature decode over the
Task API, with per-sequence completion tracking (finished sequences keep
decoding pad tokens until the wave drains).  A port of
``repro.serve.engine``; the prefill and decode calls run eagerly.

Tokens stay on the task's device until the wave ends, so a greedy wave
without ``eos_id`` makes no host sync a step.  The decode step after the
last token, whose logits the reference computes and never reads, is not
run: on a config with a global attention layer, ``max_new_tokens`` up to
``DecoderTask.GEN_MARGIN + 1`` gives the reference's ids, and more raises
``ValueError`` where the reference overwrites its cache's last slot
(ROADMAP.md queue 3); the ``ssm``, ``rec`` and local layers set no limit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    eos_id: Optional[int] = None
    pad_id: int = 0
    seed: int = 0


class Engine:
    def __init__(self, task, params):
        self.task = task
        self.params = params

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, gcfg: GenerateConfig,
                 extra_batch: Optional[dict] = None) -> np.ndarray:
        """prompts: (B, L_prompt) int32 (already padded).  Returns
        (B, max_new_tokens) generated ids (int32 numpy).  Temperature
        sampling draws from a ``torch.Generator`` on the task's device
        seeded with ``gcfg.seed``."""
        device = self.task.device
        B, Lp = prompts.shape
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=device)}
        if extra_batch:
            batch.update(extra_batch)
        caches, logits = self.task.prefill(self.params, batch)

        n_vis = getattr(self.task.cfg, "vision_tokens", 0)
        if extra_batch and "patch_embeds" in extra_batch:
            pos0 = Lp + n_vis
        else:
            pos0 = Lp

        gen = torch.Generator(device=device).manual_seed(gcfg.seed)
        n = gcfg.max_new_tokens
        out = torch.zeros((B, n), dtype=torch.int32, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        pad = torch.full((), gcfg.pad_id, dtype=torch.int32, device=device)
        tok = self._sample(logits[:, -1], gcfg, gen)

        for t in range(n):
            out[:, t] = torch.where(done, pad, tok)
            if gcfg.eos_id is not None:
                done |= tok == gcfg.eos_id
                if bool(done.all()):
                    break
            if t == n - 1:
                break
            step_batch = {"tokens": tok[:, None], "pos": pos0 + t}
            logits, caches = self.task.decode_step(self.params, step_batch,
                                                   caches)
            tok = self._sample(logits[:, -1], gcfg, gen)
        return out.cpu().numpy()

    @staticmethod
    def _sample(logits: torch.Tensor, gcfg: GenerateConfig,
                gen: torch.Generator) -> torch.Tensor:
        """Greedy: the first maximal id, as ``jnp.argmax``.  Else a draw
        from ``softmax(logits / temperature)`` (the Gumbel-max trick:
        ``argmax(logits / T - log E)``, E standard exponential)."""
        if gcfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        e = torch.empty_like(logits, dtype=torch.float32).exponential_(
            generator=gen)
        return torch.argmax(logits.float() / gcfg.temperature - torch.log(e),
                            dim=-1).to(torch.int32)
