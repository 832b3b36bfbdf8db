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
