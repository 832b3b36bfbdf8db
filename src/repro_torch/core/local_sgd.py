"""Hierarchical MapReduce training for any tree of parameters: the
cross-pod outer merge.  A port of ``repro.core.local_sgd``.

At pod scale the paper's two paradigms compose:

  * inside a pod  — the BGD paradigm: gradients summed over the ``data``
    mesh dimension every step;
  * across pods   — the SGD paradigm: each pod is one Map worker training
    locally for ``H`` steps; every ``H`` steps a Reduce merges the pods'
    parameters with the paper's strategies (average / random /
    miniloss_global).

The merge is defined over any live subset of pods (``liveness``), so a
dead or slow pod never blocks the others.  Two extensions: int8 delta
compression (the deltas from the shared anchor go over the wire as int8
under one scale agreed by a max over pods, summed in int32) and outer
momentum (Nesterov on the merged delta, DiLoCo-style).

The ``pod`` axis is a dimension of a ``DeviceMesh``: every pod's rank calls
:func:`outer_merge` with its own parameters, and each ``psum`` of the
reference is an ``all_reduce`` sum over that dimension, each ``pmax`` an
``all_reduce`` max.  The ``random`` strategy's per-pod priority cannot
replay ``jax.random.fold_in``: the caller hands each pod its draw
(``draw=``), as ``kg.fit(..., draws=...)`` takes the KG engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.parallel import util as par

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    """Cross-pod (Map-worker) merge configuration."""

    sync_period: int = 32            # H: local steps between Reduces
    strategy: str = "average"        # 'average' | 'random' | 'miniloss_global'
    compress: str = "int8"           # 'none' | 'int8'
    outer_momentum: float = 0.0      # 0 disables; 0.9 = DiLoCo-style Nesterov
    outer_lr: float = 1.0
    axis_name: str = "pod"


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def _mean_over_pods(delta: torch.Tensor, live: torch.Tensor,
                    n_live: torch.Tensor, mesh, axis: str,
                    compress: str) -> torch.Tensor:
    """Liveness-weighted mean of the pods' deltas.  With int8 the pods
    first agree a scale (a max over pods of one scalar), then sum their
    quantized deltas in int32 and descale once; a dead pod sends zeros."""
    if compress == "none":
        return par.all_reduce(delta * live, mesh, "sum", axis) / n_live
    local_amax = torch.max(torch.abs(delta)) * live
    gmax = par.all_reduce(local_amax, mesh, "max", axis)
    scale = gmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int8)
    q = torch.where(live > 0, q, torch.zeros_like(q))
    acc = par.all_reduce(q.to(torch.int32), mesh, "sum", axis)
    return acc.to(delta.dtype) * scale.to(delta.dtype) / n_live


@dataclasses.dataclass
class OuterState:
    """Carried across Reduces: the shared anchor and outer momentum."""

    anchor: PyTree
    momentum: Optional[PyTree]

    @staticmethod
    def init(params: PyTree, cfg: OuterConfig) -> "OuterState":
        """The anchor is a copy of ``params`` (a trainer updates its
        parameters in place); the momentum is zeros where enabled."""
        mom = (par.tree_map(torch.zeros_like, params)
               if cfg.outer_momentum > 0 else None)
        return OuterState(anchor=par.tree_map(torch.clone, params),
                          momentum=mom)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def outer_merge(params: PyTree, state: OuterState, cfg: OuterConfig, *,
                mesh, local_loss=None, draw=None, liveness=None):
    """The cross-pod Reduce, called by every pod's rank with its own
    parameters (a dict / tuple / list tree of tensors); returns (merged,
    new_state), the same on every live pod.

    average:           anchor + outer_lr * mean over live pods of the delta
    random:            one live pod's parameters win, the pod with the
                       largest ``draw`` (this pod's priority, a float drawn
                       by the caller; the reference draws
                       ``uniform(fold_in(key, pod))``)
    miniloss_global:   the live pod with the lowest ``local_loss`` wins.

    Ties break to the lowest pod index.  ``liveness`` (this pod's 0 or 1)
    leaves a dead pod out of the mean and out of the winners."""
    ax = cfg.axis_name
    first = _first_leaf(params)
    dev = first.device
    live = (torch.ones((), dtype=torch.float32, device=dev)
            if liveness is None
            else torch.as_tensor(liveness, device=dev).to(torch.float32))
    n_live = torch.clamp_min(par.all_reduce(live, mesh, "sum", ax), 1.0)

    if cfg.strategy == "average":
        delta = _zip_map(lambda p, a: p - a, params, state.anchor)
        mean_delta = par.tree_map(
            lambda d: _mean_over_pods(d, live, n_live, mesh, ax,
                                      cfg.compress), delta)
        if cfg.outer_momentum > 0:
            mu = cfg.outer_momentum
            new_mom = _zip_map(lambda m, d: mu * m + d, state.momentum,
                               mean_delta)
            # Nesterov lookahead
            step = _zip_map(lambda m, d: mu * m + d, new_mom, mean_delta)
        else:
            new_mom = state.momentum
            step = mean_delta
        merged = _zip_map(lambda a, s: a + cfg.outer_lr * s, state.anchor,
                          step)
        return merged, OuterState(anchor=merged, momentum=new_mom)

    if cfg.strategy in ("random", "miniloss_global"):
        idx = float(mesh.get_local_rank(ax))
        W = mesh.size(mesh.mesh_dim_names.index(ax))
        if cfg.strategy == "random":
            if draw is None:
                raise ValueError("'random' outer strategy needs a draw")
            pri = torch.as_tensor(draw, device=dev).to(torch.float32)
        else:
            if local_loss is None:
                raise ValueError("'miniloss_global' needs local_loss")
            pri = -torch.as_tensor(local_loss, device=dev).to(torch.float32)
        pri = torch.where(live > 0, pri,
                          torch.full_like(pri, float("-inf")))
        score = pri * W - idx
        best = par.all_reduce(score, mesh, "max", ax)
        mine = (score == best).to(torch.float32)
        merged = par.tree_map(
            lambda p: par.all_reduce(p * mine.to(p.dtype), mesh, "sum", ax),
            params)
        return merged, OuterState(anchor=merged, momentum=state.momentum)

    raise ValueError(f"unknown outer strategy {cfg.strategy!r}")


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


def should_sync(step, cfg: OuterConfig):
    """True on steps where the Reduce fires (step counts from 1)."""
    return (step % cfg.sync_period) == 0
