"""Deterministic sharded synthetic LM token pipeline.  A copy of
``repro.data.tokens`` (pure numpy), so the port's batches are the
reference's exactly.

Batches are a pure function of (seed, step) — the property fault-tolerant
resume depends on: a restarted job at step N regenerates exactly the batch
the dead job would have seen (train/ft.py).  The synthetic stream is a
mixture of (a) a repeated-ngram Markov source (so a real LM loss signal
exists: loss drops well below ln(V)) and (b) uniform noise tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram_order: int = 2
    noise_frac: float = 0.1


class TokenPipeline:
    """Markov-chain synthetic corpus with deterministic per-step batches."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 17]))
        # sparse-ish transition table: each token has K plausible successors
        K = 8
        self._succ = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, K)).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, int(step)]))
        B, L = cfg.global_batch, cfg.seq_len
        out = np.empty((B, L), np.int32)
        cur = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        K = self._succ.shape[1]
        choices = rng.integers(0, K, size=(B, L))
        noise = rng.random((B, L)) < cfg.noise_frac
        noise_tok = rng.integers(0, cfg.vocab_size, size=(B, L))
        for t in range(L):
            cur = self._succ[cur, choices[:, t]]
            cur = np.where(noise[:, t], noise_tok[:, t], cur).astype(np.int32)
            out[:, t] = cur
        return {"tokens": out}

    def state(self) -> dict:
        """The pipeline is stateless given (seed, step): nothing to persist
        beyond the config; recorded for the checkpoint manifest."""
        return {"seed": self.cfg.seed}
