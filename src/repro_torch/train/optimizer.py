"""Optimizers written out: SGD (with momentum), AdamW and Adafactor
(factored second moments).  A port of ``repro.train.optimizer``.

Each is a pure transform over a dict of named tensors (a model's
``named_parameters()`` names): ``init`` builds the state, ``apply``
returns new parameters, a new state and metrics, and changes none of its
inputs.  Moments are fp32 whatever the parameters' dtype; weight decay is
decoupled and touches tensors of two or more dimensions only; ``step``
counts from 1 inside ``apply``.  Dicts are walked in sorted key order,
as ``jax.tree`` walks the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # 'sgd' | 'adamw' | 'adafactor'
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9          # sgd only
    grad_clip: float = 1.0         # global-norm clip; 0 disables
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``: an fp32
    scalar on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * scale


def clip_by_global_norm(grads: Tensors, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping); ``max_norm <= 0`` returns them as they are and a
    zero norm."""
    if max_norm <= 0:
        device = next(iter(grads.values())).device if grads else None
        return grads, torch.zeros((), device=device)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                           for k in sorted(grads)))
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gnorm


# ---------------------------------------------------------------------------

def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: Tensors, cfg: OptConfig) -> dict:
    """The optimizer state of ``params``: ``step`` (an int32 scalar on
    their device) and the moments, one fp32 tensor (or, for a factored
    Adafactor leaf, a row and a column vector) per name."""
    device = next(iter(params.values())).device if params else None
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.name == "sgd":
        return {"step": step, "m": {k: _zeros32(p) for k, p in
                                    params.items()}}
    if cfg.name == "adamw":
        return {"step": step,
                "m": {k: _zeros32(p) for k, p in params.items()},
                "v": {k: _zeros32(p) for k, p in params.items()}}
    if cfg.name == "adafactor":
        def make(p):
            if _factored(p.shape, cfg.factored_min_dim):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device),
                }
            return {"v": _zeros32(p)}
        return {"step": step, "v": {k: make(p) for k, p in params.items()}}
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def _decayed(p: torch.Tensor, lr, cfg: OptConfig) -> torch.Tensor:
    """``p`` in fp32, with decoupled weight decay on a matrix or higher."""
    p32 = p.float()
    if p.dim() >= 2:
        p32 = p32 * (1 - lr * cfg.weight_decay)
    return p32


def apply(params: Tensors, grads: Tensors, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, metrics): ``metrics`` holds ``lr``
    and ``grad_norm`` as fp32 scalars on the parameters' device."""
    step = state["step"] + 1
    lr = lr_at(step, cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    metrics = {"lr": lr, "grad_norm": gnorm}

    if cfg.name == "sgd":
        m = {k: cfg.momentum * state["m"][k] + grads[k].float()
             for k in params}
        new = {k: (p.float() - lr * m[k]).to(p.dtype)
               for k, p in params.items()}
        return new, {"step": step, "m": m}, metrics

    if cfg.name == "adamw":
        m = {k: cfg.b1 * state["m"][k] + (1 - cfg.b1) * grads[k].float()
             for k in params}
        v = {k: cfg.b2 * state["v"][k]
             + (1 - cfg.b2) * torch.square(grads[k].float())
             for k in params}
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, t)
        bc2 = 1 - torch.pow(cfg.b2, t)
        new = {}
        for k, p in params.items():
            mhat = m[k] / bc1
            vhat = v[k] / bc2
            upd = mhat / (torch.sqrt(vhat) + cfg.eps)
            new[k] = (_decayed(p, lr, cfg) - lr * upd).to(p.dtype)
        return new, {"step": step, "m": m, "v": v}, metrics

    if cfg.name == "adafactor":
        t = step.to(torch.float32)
        beta = 1.0 - torch.pow(t, -cfg.decay_rate)
        new, new_v = {}, {}
        for k, p in params.items():
            g32 = grads[k].float()
            g2 = torch.square(g32) + 1e-30
            v = state["v"][k]
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp_min(
                    torch.mean(vr, dim=-1, keepdim=True), 1e-30)
                vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                new_v[k] = {"vr": vr, "vc": vc}
            else:
                vhat = beta * v["v"] + (1 - beta) * g2
                new_v[k] = {"v": vhat}
            update = g32 / torch.sqrt(vhat + 1e-30)
            # RMS-clip the update (Adafactor's d = 1.0)
            rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
            update = update / torch.clamp_min(rms, 1.0)
            new[k] = (_decayed(p, lr, cfg) - lr * update).to(p.dtype)
        return new, {"step": step, "v": new_v}, metrics

    raise ValueError(cfg.name)
