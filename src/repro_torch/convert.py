"""Carry embedding tables across from the JAX package.

The reference's parameters arrive as numpy arrays (``np.asarray`` of its
jax arrays, or an ``arrays.npz`` it saved); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.kg import KG
from repro_torch.kb import KnowledgeBase


def params_from_reference(
    params: Dict[str, np.ndarray],
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The reference's ``{table_name: (N, k) array}`` as tensors of
    ``dtype`` on ``device`` (default: the GPU; raises without one unless
    ``device`` is given)."""
    device = resolve_device(device)
    return {
        name: torch.tensor(np.asarray(arr), dtype=dtype, device=device)
        for name, arr in params.items()
    }


def kb_from_reference(
    params: Dict[str, np.ndarray],
    model: str = "transe",
    graph=None,
    *,
    norm: str = "l1",
    meta: Optional[dict] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> KnowledgeBase:
    """A port ``KnowledgeBase`` over the reference's tables.  ``graph`` is
    any object with ``n_entities``, ``n_relations`` and numpy
    ``train``/``valid``/``test`` splits (a reference ``KG`` will do); its
    splits are copied into a port ``KG``."""
    port_graph = None
    if graph is not None:
        port_graph = KG(
            int(graph.n_entities), int(graph.n_relations),
            np.asarray(graph.train, np.int32),
            np.asarray(graph.valid, np.int32),
            np.asarray(graph.test, np.int32))
    return KnowledgeBase(
        model=model, params=params_from_reference(params, device, dtype),
        graph=port_graph, norm=norm, meta=dict(meta or {}))


def lm_params_from_reference(params, cfg, device=None):
    """A port ``DecoderLM`` holding the reference's LM parameters.

    ``params`` is the reference ``DecoderLM.init``'s pytree with every leaf
    turned into a numpy array: ``embed``, ``ln_f`` and one ``seg{s}`` per
    segment, a tuple over the segment's pattern of dicts stacked over its
    repeats.  Segment ``s``'s pattern entry ``i`` at repeat ``rep`` becomes
    the port's layer ``offset_s + rep * len(pattern) + i``
    (recurrentgemma-9b's trailing (rec, rec) segment: layers 36 and 37);
    a MoE FFN's padded expert rows, and an SSM or RG-LRU mixer's leaves
    (the block-diagonal (nb, drb, drb) gates included), are copied as
    they are.  Values are
    copied in ``cfg.param_dtype`` onto ``device`` (default: the GPU;
    raises without one unless ``device`` is given)."""
    from repro_torch.models.transformer import DecoderLM

    model = DecoderLM(cfg, device)

    def load(dst, src):
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))

    def load_layer(dst, src, rep):
        """Copy repeat ``rep`` of a segment's stacked dict into ``dst``,
        descending into nested dicts (a MoE FFN's ``shared`` MLP)."""
        for key, val in src.items():
            if isinstance(val, dict):
                load_layer(getattr(dst, key), val, rep)
            else:
                load(getattr(dst, key), val[rep])

    for name, arr in params["embed"].items():
        load(model.embed[name], arr)
    load(model.ln_f, params["ln_f"])
    layer = 0
    for s, (pattern, reps) in enumerate(cfg.segments):
        seg = params[f"seg{s}"]
        for rep in range(reps):
            for i in range(len(pattern)):
                load_layer(model.layers[layer + rep * len(pattern) + i],
                           seg[i], rep)
        layer += reps * len(pattern)
    return model
