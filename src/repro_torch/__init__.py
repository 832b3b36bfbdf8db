"""PyTorch port of the KG-embedding system in ``repro``, for NVIDIA GPUs.

The JAX package ``repro`` is the reference; this package mirrors its file
layout and answers the same calls with the same numbers (the parity tests
in ``tests/test_torch_*.py`` hold each module against its counterpart).
It imports ``torch`` and never ``jax``, nor anything of ``repro``.

Ported so far: the three registered scoring models (TransE, TransH,
DistMult) with per-triplet or joint negatives; training on the host and
device pipelines (``kg.fit``,
the paper's SGD and BGD paradigms with simulated workers and the dense
or the sparse Reduce transport, ``merge_transport="sparse"``: compact
steps and packed-delta Reduces with the dense bits; ``pipeline="device"``
runs blocks of epochs drawn on the device, with ``merge_every`` local
epochs between Reduces, ``repartition_every`` and bounded staleness,
``staleness``; ``table_sharding="sharded"`` routes each merged row to
the shard that owns it), with
in-training evaluation and early stopping (``eval_every``, ``patience``,
``keep_best``; ``core/trace.py``) and bit-identical checkpoint/resume
(``ckpt_dir``, ``checkpoint_every``, ``resume``) in the reference's
format; and the serving and evaluation path — ``KnowledgeBase`` save /
load, top-k queries, the live serving tier (``serve.KGServer``: waves,
power-of-two buckets, warm-up, the LRU answer cache, hot swap and
tenants), and the paper's three-task evaluation, over whole or sharded
tables; and the online tier (``kb.update`` / ``kg.update``: grown tables,
warm-started rows and a masked fine-tune of the touched rows, delta
checkpoint chains replayed by ``KnowledgeBase.load_chain``, and
``online.RefreshDaemon`` swapping refreshed artifacts into a live
server); the ``--kg`` launcher (``python -m repro_torch.launch.train``);
and the ``shard_map`` backend over ``torch.distributed``
(``kg.fit(backend="shard_map", mesh=...)``: the workers split over the
ranks of a ``DeviceMesh``, the Reduce a collective,
``parallel/util.py``); LM serving for the whole zoo (``models``,
``configs``, ``serve.engine``: prefill and KV-cache, MLA latent-cache or
recurrent-state decode, the scatter MoE FFN, whisper's encoder-decoder;
``python -m repro_torch.launch.serve``); and LM training on one device
(``train``: chunked cross entropy, SGD, AdamW and Adafactor, the
``Trainer`` with checkpoints and supervised restart, over the synthetic
token stream; ``python -m repro_torch.launch.train --arch``).  The
reference's two Pallas kernels are hand-written CUDA kernels for Hopper:
the entity-ranking sweep (``kernels/rank_topk.py``) and TransE's
training step, forward and backward (``kernels/transe_score.py``).  What
is not ported yet raises, naming its item in ROADMAP.md queue 1.

Entry points that create tensors take a ``device``; left out, it is the
current CUDA device, and without a GPU they raise (:func:`resolve_device`)
instead of running on the CPU unasked.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on: ``device`` when
    given, else ``cuda``.  Raises when no GPU is present and none was
    named, or ``cuda`` was — pass ``device="cpu"`` to run on the CPU on
    purpose."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or torch.cuda.is_available():
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points default to the GPU, and no CUDA device "
            "is available: pass device='cpu' to run on the CPU")
    return torch.device("cuda")
