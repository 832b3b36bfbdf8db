"""Loss functions.  A port of ``repro.train.losses``.

``chunked_cross_entropy`` is the memory-critical one: a large-vocab model
at many tokens a step would hold gigabytes of logits if it computed them
all at once.  It walks the sequence in chunks and computes each chunk's
(B·chunk, V) logits under ``torch.utils.checkpoint``, so at most one
chunk's logits are live in the forward, and the backward recomputes them
chunk by chunk instead of keeping them (the reference's ``jax.checkpoint``
of its scan body).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import util as par

IGNORE = -100


def _chunk_loss(hidden_c, labels_c, unembed_fn):
    """hidden (C, d), labels (C,) -> (sum_nll, n_valid), both fp32.

    The gold logit is a gather.  The reference takes it as a masked sum
    over the vocabulary (an iota compare, so a vocab-sharded unembedding
    all-reduces only (C,) scalars); on one device the gather reads the
    same value: a sum of zeros and one logit is that logit exactly, and
    its gradient is the same one-hot."""
    logits = unembed_fn(hidden_c)                       # (C, V) fp32
    valid = labels_c != IGNORE
    safe = torch.where(valid, labels_c, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, safe[:, None])[:, 0]
    mask = valid.to(torch.float32)
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,      # (B, L, d)
    labels: torch.Tensor,      # (B, L) int, IGNORE (-100) masked out
    unembed_fn: Callable,      # (N, d) -> (N, V) fp32 logits
    chunk: int = 2048,
) -> torch.Tensor:
    """Mean next-token NLL over valid labels, the vocabulary never fully
    live.  Chunks run along the sequence, keeping the batch whole (the
    reference's layout: the batch is the data-sharded axis); a chunk
    that does not divide L pads the last one with ignored positions."""
    B, L, d = hidden.shape
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        hc = hidden[:, c0:c0 + chunk].reshape(B * chunk, d)
        yc = labels[:, c0:c0 + chunk].reshape(B * chunk)
        s, n = par.remat(_chunk_loss, hc, yc, unembed_fn)
        total = total + s
        count = count + n
    return total / torch.clamp_min(count, 1.0)


def full_cross_entropy(hidden, labels, unembed_fn):
    """The unchunked loss, for tests."""
    d = hidden.shape[-1]
    s, n = _chunk_loss(hidden.reshape(-1, d), labels.reshape(-1),
                       unembed_fn)
    return s / torch.clamp_min(n, 1.0)


def shift_labels(tokens: torch.Tensor,
                 pad_id: Optional[int] = None) -> torch.Tensor:
    """Next-token labels: labels[t] = tokens[t+1]; last position ignored."""
    labels = torch.cat(
        [tokens[:, 1:], torch.full((tokens.shape[0], 1), IGNORE,
                                   dtype=tokens.dtype,
                                   device=tokens.device)], dim=1)
    if pad_id is not None:
        labels = torch.where(labels == pad_id, IGNORE, labels)
    return labels
