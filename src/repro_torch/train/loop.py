"""The LM training loop: the step (forward, backward, optimizer),
microbatch gradient accumulation, and checkpoint and restart.  A port of
``repro.train.loop`` on one device.

``make_train_step`` builds the step (``loss_and_grads``, then the
optimizer); ``Trainer`` drives it on the host,
with fault tolerance left to ``train/ft.py``.  The parameters live in the
task's module (``task.init``'s ``DecoderLM`` or ``EncDecLM``): a step
takes the gradients of ``task.loss`` with respect to its named
parameters, hands them to ``optimizer.apply`` as a dict of named tensors,
and copies the new values back into the module.  The reference's mesh
(``param_shardings``, the sharded ``jax.jit``) and its cross-pod outer
loop (``TrainConfig.outer``, ``core/local_sgd.py``) are ROADMAP.md items
16f and 16e's rest.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # gradient-accumulation factor
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3


def named_params(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters by name, detached: the optimizer's view."""
    return {k: p.detach() for k, p in params.named_parameters()}


def value_and_grad(task, params: torch.nn.Module, batch):
    """(loss, grads): ``task.loss(params, batch)`` detached, and its
    gradient with respect to every named parameter (zeros where the loss
    does not reach one, as ``jax.grad`` gives)."""
    names, leaves = zip(*params.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = task.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for k, p, g in zip(names, leaves, grads)}


def _split(batch, microbatches: int, i: int):
    """Microbatch ``i`` of ``batch``: every array's leading dim cut in
    ``microbatches`` equal runs (the reference's reshape to
    (microbatches, B // microbatches, ...))."""
    def one(x):
        n = x.shape[0] // microbatches
        return x[i * n:(i + 1) * n]
    return {k: one(v) for k, v in batch.items()}


def loss_and_grads(task, params: torch.nn.Module, batch,
                   microbatches: int = 1):
    """(loss, grads) of one step: with microbatches > 1 the batch's
    leading dim is split and the gradients are summed in fp32 one
    microbatch after another (peak activation memory divides by the
    factor), then divided by the count, as is the loss."""
    if microbatches == 1:
        return value_and_grad(task, params, batch)
    loss, grads = 0.0, {}
    for i in range(microbatches):
        li, gi = value_and_grad(task, params,
                                _split(batch, microbatches, i))
        loss = loss + li
        for k, g in gi.items():
            grads[k] = grads[k] + g.float() if k in grads else g.float()
    return loss / microbatches, {k: g / microbatches
                                 for k, g in grads.items()}


def make_train_step(task, opt_cfg: opt_lib.OptConfig,
                    microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics):
    :func:`loss_and_grads`, then ``optimizer.apply``.  ``params`` is the
    task's module, updated in place and returned."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(task, params, batch, microbatches)
        new, opt_state, metrics = opt_lib.apply(
            named_params(params), grads, opt_state, opt_cfg)
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(new[k])
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Trainer:
    """The host-side loop on the task's device: init or resume, the
    step loop over ``pipeline.batch(step)``, the loss history, logging,
    asynchronous checkpoints every ``ckpt_every`` steps and a final
    save.  A failure inside the loop waits for the checkpoint in flight
    to commit before it propagates."""

    def __init__(self, task, pipeline, opt_cfg: opt_lib.OptConfig,
                 train_cfg: TrainConfig):
        self.task = task
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.saver = ckpt_lib.AsyncSaver()
        self.step_fn = make_train_step(task, opt_cfg, train_cfg.microbatches)
        self.history: list = []

    def run(self, seed: int = 0, resume: bool = True):
        """Train to ``cfg.steps``, from the latest checkpoint in
        ``cfg.ckpt_dir`` where ``resume`` and one exists, else from a
        fresh init drawn from ``torch.Generator`` seeded with ``seed``.
        Returns (params, opt_state)."""
        cfg = self.cfg
        device = self.task.device
        params = self.task.init(
            torch.Generator(device=device).manual_seed(seed))
        opt_state = opt_lib.init(named_params(params), self.opt_cfg)

        start = 0
        if resume and cfg.ckpt_dir and \
                ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            start, stored, stored_opt, _ = ckpt_lib.restore(
                cfg.ckpt_dir, params_template=named_params(params),
                opt_template=opt_state)
            with torch.no_grad():
                for k, p in params.named_parameters():
                    p.copy_(stored[k])
            opt_state = _to_device(stored_opt, device)
            start = int(start)

        t0 = time.time()
        try:
            for step in range(start, cfg.steps):
                batch = self.pipeline.batch(step)
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])
                self.history.append(loss)
                if cfg.log_every and (step + 1) % cfg.log_every == 0:
                    dt = time.time() - t0
                    print(f"step {step + 1}: loss={loss:.4f} "
                          f"({dt / max(step + 1 - start, 1):.2f}s/step)")
                if cfg.ckpt_dir and cfg.ckpt_every and \
                        (step + 1) % cfg.ckpt_every == 0:
                    self.saver.save_async(
                        cfg.ckpt_dir, step + 1, named_params(params),
                        opt_state, extra={"pipeline": self.pipeline.state()},
                        keep=cfg.keep_ckpts)
        except BaseException:
            # the checkpoint in flight commits before the failure goes on,
            # so a restart resumes from it, and never races its writer
            # for the same step directory (ROADMAP.md queue 3)
            self.saver.wait()
            raise
        if cfg.ckpt_dir:
            self.saver.wait()
            ckpt_lib.save(cfg.ckpt_dir, cfg.steps, named_params(params),
                          opt_state,
                          extra={"pipeline": self.pipeline.state()},
                          keep=cfg.keep_ckpts)
        return params, opt_state
