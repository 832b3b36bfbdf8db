"""The LM training loop: the step (forward, backward, optimizer),
microbatch gradient accumulation, and checkpoint and restart.  A port of
``repro.train.loop`` on one device.

``make_train_step`` builds the step (``loss_and_grads``, then the
optimizer); ``Trainer`` drives it on the host,
with fault tolerance left to ``train/ft.py``.  The parameters live in the
task's module (``task.init``'s ``DecoderLM`` or ``EncDecLM``): a step
takes the gradients of ``task.loss`` with respect to its named
parameters, hands them to ``optimizer.apply`` as a dict of named tensors,
and copies the new values back into the module.

Over a mesh (``Trainer(mesh=...)``, the reference's sharded ``jax.jit``)
every rank runs the same loop: the parameters and the optimizer state
rest as DTensors placed by ``parallel.sharding.param_shardings`` /
``opt_shardings``, the batch is cut by ``data_shardings`` (each rank
computes on its rows), and each layer gathers its parameters where it
uses them (``parallel.util.local_params``).  Each rank's loss is its
rows' mean over the number of batch shards, so the gradients, reduced
back onto the parameters' placements, are the global batch's; the
optimizer runs on the DTensors.  ``TrainConfig.outer`` (the cross-pod
merge, ``core/local_sgd.py``) is declared and not called, as in the
reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import local_sgd
from repro_torch.parallel import sharding as shard_lib
from repro_torch.parallel import util as par
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
    # cross-pod MapReduce outer loop (None = plain synchronous DP); the
    # reference's Trainer declares it and does not call it, nor does this
    outer: Optional[local_sgd.OuterConfig] = None


def named_params(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters by name, detached: the optimizer's view."""
    return {k: p.detach() for k, p in params.named_parameters()}


def value_and_grad(task, params: torch.nn.Module, batch):
    """(loss, grads): ``task.loss(params, batch)`` detached, and its
    gradient with respect to every named parameter (zeros where the loss
    does not reach one, as ``jax.grad`` gives).  Under a mesh whose batch
    is cut into n shards, the gradient is taken of the loss over n (its
    share of the global mean)."""
    names, leaves = zip(*params.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    shards = par.batch_shards(par.mesh_context())
    with torch.enable_grad():
        loss = task.loss(params, batch)
        grads = torch.autograd.grad(loss if shards == 1 else loss / shards,
                                    leaves, allow_unused=True)
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
                    microbatches: int = 1,
                    param_shardings=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics):
    :func:`loss_and_grads`, then ``optimizer.apply``.  ``params`` is the
    task's module, updated in place and returned.

    With ``param_shardings`` ({name: spec}) the step runs over a mesh:
    the parameters and optimizer state are DTensors on it, ``batch`` is a
    dict of DTensors cut by ``data_shardings`` (:func:`shard_batch`), and
    each gradient is pinned to its parameter's placements.  The loss in
    the metrics is the global batch's mean; each rank splits its own rows
    into at most ``microbatches`` that divide them.  The step's two halves
    are ``step.grads(params, batch) -> (loss, grads)`` and
    ``step.update(params, opt_state, grads, loss)`` (the dry-run traces
    them apart)."""

    def grads(params, batch):
        """(loss, grads) of the step: the global batch's mean loss."""
        if param_shardings is None:
            return loss_and_grads(task, params, batch, microbatches)
        from torch.distributed.tensor import DTensor, Partial, Replicate

        first = next(iter(batch.values()))
        mesh = first.device_mesh
        axes = tuple(a for a, pl in zip(mesh.mesh_dim_names,
                                        first.placements) if pl.is_shard())
        local = {k: v.to_local() for k, v in batch.items()}
        # the rank splits its own rows: never into more microbatches than
        # they divide into (the reference splits the global batch; the
        # mean over microbatches is the same)
        mb = math.gcd(microbatches, first.to_local().shape[0])
        with par.use_mesh(mesh, axes, task.cfg.sharding_profile):
            loss, grads = loss_and_grads(task, params, local, mb)
            shards = par.batch_shards(par.mesh_context())
        grads = {k: _pin(g, shard_lib.placements(param_shardings[k], mesh))
                 for k, g in grads.items()}
        loss = DTensor.from_local(
            (loss / shards).reshape(()), mesh,
            [Partial() if a in axes else Replicate()
             for a in mesh.mesh_dim_names]).full_tensor()
        return loss, grads

    def update(params, opt_state, grads, loss):
        """``optimizer.apply``, the new values copied into ``params``."""
        with contextlib.ExitStack() as stack:
            if param_shardings is not None:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            new, opt_state, metrics = opt_lib.apply(
                named_params(params), grads, opt_state, opt_cfg)
            with torch.no_grad():
                for k, p in params.named_parameters():
                    p.copy_(new[k])
        metrics["loss"] = loss
        return params, opt_state, metrics

    def step(params, opt_state, batch):
        loss, g = grads(params, batch)
        return update(params, opt_state, g, loss)

    step.grads, step.update = grads, update
    return step


def _pin(g, placements):
    """A gradient on its parameter's placements (a redistribution only
    where autograd left it elsewhere)."""
    if tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(g.device_mesh, placements)


def shard_batch(batch, specs, mesh):
    """The global batch as DTensors cut by ``specs`` (``data_shardings``):
    every rank keeps its rows of the full host batch, with no
    communication."""
    return par.distribute_tree(batch, specs, mesh)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Trainer:
    """The host-side loop on the task's device: init or resume, the
    step loop over ``pipeline.batch(step)``, the loss history, logging,
    asynchronous checkpoints every ``ckpt_every`` steps and a final
    save.  A failure inside the loop waits for the checkpoint in flight
    to commit before it propagates.

    With ``mesh`` (a ``DeviceMesh`` over ``("data", "model")`` or
    ``("pod", "data", "model")``, ``launch/mesh.py``) every rank of the
    mesh runs the loop: the parameters and optimizer state are placed by
    the config's profile, each batch cut by ``data_shardings``; a
    checkpoint holds the whole tensors, written by the mesh's first rank
    (every rank restores from it)."""

    def __init__(self, task, pipeline, opt_cfg: opt_lib.OptConfig,
                 train_cfg: TrainConfig, mesh=None):
        self.task = task
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.saver = ckpt_lib.AsyncSaver()
        self.step_fn = None
        self.history: list = []

    def _build(self, params, opt_state):
        """The step, and (over a mesh) the parameters and optimizer state
        placed on it: returns (params, opt_state, batch specs or None)."""
        if self.mesh is None:
            self.step_fn = make_train_step(self.task, self.opt_cfg,
                                           self.cfg.microbatches)
            return params, opt_state, None
        profile = self.task.cfg.sharding_profile
        p_sh = shard_lib.param_shardings(params, self.mesh, profile)
        o_sh = shard_lib.opt_shardings(opt_state, p_sh, self.mesh, profile)
        b_sh = shard_lib.data_shardings(self.pipeline.batch(0), self.mesh,
                                        profile)
        self.step_fn = make_train_step(self.task, self.opt_cfg,
                                       self.cfg.microbatches,
                                       param_shardings=p_sh)
        par.distribute_module(params, p_sh, self.mesh)
        opt_state = par.distribute_tree(opt_state, o_sh, self.mesh)
        return params, opt_state, b_sh

    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.get_rank() == 0

    def _save(self, step, params, opt_state, final: bool):
        host_p = par.full_tree(named_params(params))
        host_o = par.full_tree(opt_state)
        if self._writer():
            extra = {"pipeline": self.pipeline.state()}
            if final:
                ckpt_lib.save(self.cfg.ckpt_dir, step, host_p, host_o,
                              extra=extra, keep=self.cfg.keep_ckpts)
            else:
                self.saver.save_async(self.cfg.ckpt_dir, step, host_p,
                                      host_o, extra=extra,
                                      keep=self.cfg.keep_ckpts)

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
        params, opt_state, b_sh = self._build(params, opt_state)

        t0 = time.time()
        try:
            for step in range(start, cfg.steps):
                batch = self.pipeline.batch(step)
                if b_sh is not None:
                    batch = shard_batch(_to_device(
                        {k: torch.as_tensor(v) for k, v in batch.items()},
                        device), b_sh, self.mesh)
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
                    self._save(step + 1, params, opt_state, final=False)
        except BaseException:
            # the checkpoint in flight commits before the failure goes on,
            # so a restart resumes from it, and never races its writer
            # for the same step directory (ROADMAP.md queue 3)
            self.saver.wait()
            raise
        if cfg.ckpt_dir:
            self.saver.wait()
            self._save(cfg.steps, params, opt_state, final=True)
            if self.mesh is not None and self.mesh.size() > 1:
                torch.distributed.barrier()     # the writer's save lands
        return params, opt_state
