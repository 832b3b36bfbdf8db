"""The MapReduce KG-embedding engine (paper §3), port of
``repro.core.mapreduce``: the ``host`` pipeline on the ``vmap`` backend
with the dense Reduce.  Most callers use ``repro_torch.kg.fit``.

Two paradigms, as the paper structures them:

  * **SGD-based** (§3.1): Map = each worker runs a full local-SGD epoch on
    its balanced subset with a private copy of the embeddings; Reduce =
    merge the W inconsistent copies per key (``core/merge.py``), table by
    table, routed by the model's ``param_roles()``.
  * **BGD-based** (§3.2): Map = each worker computes the *gradient* of its
    batch; Reduce = mean of the gradients; one global update.

The W workers are simulated on one device, as the reference's ``vmap``
backend does: the SGD workers' tables are one stacked ``(W, N, k)`` tensor
on the card, and each step of all W workers is one launch of each
``transe_score`` kernel (BGD's shared tables enter the kernels as a
worker-stride-0 view, so each worker's gradient comes back separately).

The host pipeline builds each epoch's batches on the host
(``data/kg.epoch_batches``, a pure function of (seed, epoch)) and draws
its negatives and the ``random`` strategy's priorities from CPU
``torch.Generator``s seeded by (seed, epoch, stream): every epoch's draws
are a pure function of (seed, epoch), the same on every device, and one
seed gives the same run twice.  The reference draws from a ``jax.random``
key chain instead; ``train(draws=...)`` takes an epoch's draws from the
caller, which is how the parity tests replay the reference's.

In-training evaluation and checkpoint/resume ride the Reduce boundaries,
which on the host pipeline are every epoch: ``train(eval_loop=...)``
evaluates every ``eval_every`` epochs and at the last one
(``core/trace.py``: a ``TrainingTrace``, early stopping on ``patience``,
the best params kept), and ``train(checkpoint=...)`` saves params and a
manifest (:class:`CheckpointConfig`, through ``train/checkpoint.py``'s
``AsyncSaver`` by default).  A resume (``start_epoch`` with the saved
params and loss history) continues bit-identically: every epoch's
batches and draws are a pure function of (seed, absolute epoch), so
nothing needs replaying.  The manifest holds the reference's fields
(:func:`resume_config` among them), so a checkpoint resumes in either
package.

Not ported yet, each raising and naming its ROADMAP.md item: the device
pipeline and non-default ``EpochSchedule`` (item 9b), the sparse transport
(item 11), the ``shard_map`` backend, sharded tables and staleness
(item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import merge as merge_lib
from repro_torch.core import models as kg_models
from repro_torch.core import negative
from repro_torch.core import trace as trace_lib
from repro_torch.core.models.base import (
    EpochStats, KGConfig, KGModel, Params, apply_gradients)
from repro_torch.data import kg as kg_lib
from repro_torch.train import checkpoint as checkpoint_lib
from repro_torch.util import exact_div, not_ported, warn_fresh

#: an epoch's draws: its negatives (W, S, B, 3) and, for the ``random``
#: strategy, each table's merge priorities (W, N)
Draws = Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]

_NEGATIVES, _PRIORITIES = 0, 1          # per-epoch random streams


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """How the device pipeline groups epochs.  The host pipeline runs one
    epoch at a time with a Reduce after each, which is the default
    schedule; any other drives the device pipeline, not ported yet."""

    block_epochs: int = 1
    merge_every: int = 1
    repartition_every: Optional[int] = None

    def __post_init__(self):
        if (self.block_epochs, self.merge_every,
                self.repartition_every) != (1, 1, None):
            raise not_ported(
                "an EpochSchedule other than one epoch per block with a "
                "Reduce every epoch (the device pipeline)", 9)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Periodic training checkpoints at Reduce boundaries (``train()`` /
    ``kg.fit(checkpoint_every=K, ckpt_dir=...)``).

    ``every`` counts epochs between snapshots; ``None`` saves only the
    final state.  The run's last epoch (including an early stop) is
    always checkpointed, so a resume can always continue.  Saves go
    through ``train/checkpoint.AsyncSaver`` by default — the loop pays the
    device-to-host copy, a daemon thread the disk I/O; ``synchronous=True``
    writes in line.

    The manifest records model name, seed, graph fingerprint, epoch, the
    loss history so far and :func:`resume_config` — everything
    ``kg.fit(resume=True)`` needs to continue bit-identically, in either
    package."""

    ckpt_dir: str
    every: Optional[int] = None
    keep: int = 3
    synchronous: bool = False

    def __post_init__(self):
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1 (or None), got {self.every}")


def resume_config(tcfg: KGConfig, cfg: "MapReduceConfig") -> dict:
    """The manifest fields a resume must match for bit-identity: every
    knob that shapes the training trajectory — partitioning, batching,
    schedule, paradigm/pipeline/strategy, and the scalar hyperparameters.
    The reference's dict, field for field: ``backend``, ``block_epochs``,
    ``merge_transport``, ``table_sharding`` and ``touched_capacity`` are
    absent, as there (each is proved not to change the trajectory)."""
    return {
        "paradigm": cfg.paradigm,
        "pipeline": cfg.pipeline,
        "n_workers": cfg.n_workers,
        "batch_size": cfg.batch_size,
        "partition": cfg.partition,
        "staleness": cfg.staleness,
        "strategy": cfg.strategy if cfg.paradigm == "sgd" else None,
        "merge_every": cfg.schedule.merge_every,
        "repartition_every": cfg.schedule.repartition_every,
        "margin": tcfg.margin,
        "norm": tcfg.norm,
        "learning_rate": tcfg.learning_rate,
        "normalize": tcfg.normalize,
        "sampling": tcfg.sampling,
    }


class _CheckpointWriter:
    """The training loop's checkpoint hook: owns the saver and the
    manifest fields every save shares; the loop calls ``due`` / ``save``
    at each boundary and ``finish`` at the end."""

    def __init__(self, cfg: CheckpointConfig, base_extra: dict):
        self.cfg = cfg
        self.base = base_extra
        self.saver = None if cfg.synchronous else checkpoint_lib.AsyncSaver()
        self.last_saved: Optional[int] = None

    def due(self, done: int, epochs: int, stopping: bool = False) -> bool:
        if done == self.last_saved:
            return False
        return (
            done == epochs
            or stopping
            or (self.cfg.every is not None and done % self.cfg.every == 0)
        )

    def save(self, done: int, params, history) -> None:
        extra = dict(self.base, epoch=done, loss_history=list(history))
        self.last_saved = done
        if self.saver is None:
            checkpoint_lib.save(self.cfg.ckpt_dir, done, params, extra=extra,
                                keep=self.cfg.keep)
        else:
            self.saver.save_async(self.cfg.ckpt_dir, done, params,
                                  extra=extra, keep=self.cfg.keep)

    def finish(self) -> None:
        if self.saver is not None:
            self.saver.wait()


@dataclasses.dataclass(frozen=True)
class MapReduceConfig:
    n_workers: int = 4
    paradigm: str = "sgd"           # 'sgd' | 'bgd'
    strategy: str = "average"       # merge_lib.STRATEGIES (sgd paradigm only)
    merge_transport: str = "dense"  # 'dense' ('sparse' not ported yet)
    backend: str = "vmap"           # 'vmap' ('shard_map' not ported yet)
    batch_size: int = 256
    # host partitioner (data/kg.PARTITIONERS): 'balanced' | 'stratified' |
    # 'degree' | 'overlap'
    partition: str = "balanced"
    model: str = "transe"           # kg_models registry name
    pipeline: str = "host"          # 'host' ('device' not ported yet)
    schedule: EpochSchedule = EpochSchedule()
    # raise instead of warn when batch_size doesn't divide the worker split
    strict_batching: bool = False
    table_sharding: str = "replicated"   # 'sharded' not ported yet
    touched_capacity: Optional[int] = None   # sparse transport only
    staleness: int = 0

    @property
    def partitioner(self) -> str:
        """Public alias of ``partition``."""
        return self.partition

    def __post_init__(self):
        if self.paradigm not in ("sgd", "bgd"):
            raise ValueError(f"bad paradigm {self.paradigm!r}")
        if self.paradigm == "sgd" and self.strategy not in merge_lib.STRATEGIES:
            raise ValueError(f"bad strategy {self.strategy!r}")
        if self.merge_transport not in ("dense", "sparse"):
            raise ValueError(f"bad merge_transport {self.merge_transport!r}")
        if self.table_sharding not in ("replicated", "sharded"):
            raise ValueError(f"bad table_sharding {self.table_sharding!r}")
        if self.backend not in ("vmap", "shard_map"):
            raise ValueError(f"bad backend {self.backend!r}")
        if self.pipeline not in ("host", "device"):
            raise ValueError(f"bad pipeline {self.pipeline!r}")
        if self.partition not in kg_lib.PARTITIONERS:
            raise ValueError(
                f"bad partition {self.partition!r}; want one of "
                f"{tuple(kg_lib.PARTITIONERS)}")
        if self.staleness < 0:
            raise ValueError(
                f"staleness must be >= 0, got {self.staleness}")
        if self.pipeline == "device":
            raise not_ported("pipeline='device'", 9)
        if self.merge_transport == "sparse" or \
                self.touched_capacity is not None:
            raise not_ported("merge_transport='sparse' (touched_capacity)",
                             11)
        if self.backend == "shard_map":
            raise not_ported("backend='shard_map'", 12)
        if self.table_sharding == "sharded":
            raise not_ported("table_sharding='sharded'", 12)
        if self.staleness > 0:
            raise not_ported("staleness > 0", 12)
        kg_models.get_model(self.model)      # raises on unknown name


def _resolve(cfg: MapReduceConfig, model: Optional[KGModel]) -> KGModel:
    return kg_models.get_model(model if model is not None else cfg.model)


# ---------------------------------------------------------------------------
# SGD paradigm
# ---------------------------------------------------------------------------

def _stats_for_role(stats: EpochStats, role: str):
    if role == "ent":
        return stats.ent_count, stats.ent_loss
    return stats.rel_count, stats.rel_loss


def _merge_tables_stacked(
    model: KGModel, strategy: str, stacked: Params, stats: EpochStats,
    priorities: Optional[Dict[str, torch.Tensor]],
) -> Params:
    """Reduce every table of the stacked (leading worker axis) params,
    routed by the model's entity/relation roles, in sorted name order."""
    roles = model.param_roles()
    out = {}
    for name in sorted(stacked):
        count, loss = _stats_for_role(stats, roles[name])
        out[name] = merge_lib.merge_stacked(
            strategy, stacked[name], count, loss, stats.mean_loss,
            None if priorities is None else priorities[name])
    return out


def sgd_epoch_vmap(
    params: Params,
    pos: torch.Tensor,               # (W, S, B, 3)
    neg: torch.Tensor,               # (W, S, B, 3)
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    priorities: Optional[Dict[str, torch.Tensor]] = None,
    model: Optional[KGModel] = None,
) -> tuple:
    """Map (local epochs of all W workers from the shared params, side by
    side on stacked copies) + Reduce (stacked merge): ``(params, loss)``."""
    model = _resolve(cfg, model)
    W = pos.shape[0]
    stacked = {name: p.unsqueeze(0).repeat(W, *(1,) * p.dim())
               for name, p in params.items()}
    stacked, stats = model.run_epoch(
        stacked, pos, neg, tcfg,
        touch_losses=cfg.strategy == "miniloss_perkey")
    merged = _merge_tables_stacked(model, cfg.strategy, stacked, stats,
                                   priorities)
    return merged, merge_lib.worker_mean(stats.mean_loss)


# ---------------------------------------------------------------------------
# BGD paradigm
# ---------------------------------------------------------------------------

def bgd_epoch_vmap(
    params: Params,
    pos: torch.Tensor,               # (W, S, B, 3)
    neg: torch.Tensor,
    cfg: MapReduceConfig,
    tcfg: KGConfig,
    model: Optional[KGModel] = None,
) -> tuple:
    """Per step: Map = per-worker gradients, Reduce = their mean, one global
    update.  Mathematically single-thread minibatch SGD on the W·B-sized
    union batch.  Returns ``(params, loss)``."""
    model = _resolve(cfg, model)
    if tcfg.normalize == "epoch":
        params = model.normalize(params)
    n_steps = pos.shape[1]
    loss_sum = torch.zeros((), dtype=tcfg.dtype, device=params["ent"].device)
    for s in range(n_steps):
        losses, grads = model.batch_gradients(params, pos[:, s], neg[:, s],
                                              tcfg)
        grads = {name: merge_lib.worker_mean(g) for name, g in grads.items()}
        params = apply_gradients(params, grads, tcfg.learning_rate)
        if tcfg.normalize == "step":
            params = model.normalize(params)
        loss_sum = loss_sum + merge_lib.worker_mean(losses)
    return params, exact_div(loss_sum, n_steps)


# ---------------------------------------------------------------------------
# Epoch dispatcher + host-side training loop
# ---------------------------------------------------------------------------

def make_epoch_fn(
    cfg: MapReduceConfig, tcfg: KGConfig, model: Optional[KGModel] = None
) -> Callable:
    """``epoch_fn(params, pos, neg, priorities) -> (params, loss)`` for the
    configured paradigm (BGD ignores ``priorities``)."""
    model = _resolve(cfg, model)
    if cfg.paradigm == "sgd":
        return lambda p, pos, neg, pri: sgd_epoch_vmap(
            p, pos, neg, cfg, tcfg, pri, model)
    return lambda p, pos, neg, pri: bgd_epoch_vmap(
        p, pos, neg, cfg, tcfg, model)


@dataclasses.dataclass
class TrainResult:
    params: Params
    loss_history: list
    epochs_run: int
    model: str = "transe"
    # in-training evaluation (eval_loop / kg.fit(eval_every=...)): the
    # quality-vs-epoch trace, and — when keep_best — the params of the
    # best-metric boundary (paper-style model selection)
    trace: Optional[trace_lib.TrainingTrace] = None
    best_params: Optional[Params] = None
    best_epoch: Optional[int] = None
    # the persistent/serveable artifact view of this result — a
    # repro_torch.kb.KnowledgeBase assembled by kg.fit (None when train()
    # is driven directly below the facade)
    kb: Optional[object] = None


def _make_recorder(
    kg, tcfg: KGConfig, model: KGModel,
    eval_loop: Optional[trace_lib.EvalLoopConfig],
) -> Optional[trace_lib.TraceRecorder]:
    if eval_loop is None:
        return None
    return trace_lib.TraceRecorder(
        eval_loop, trace_lib.make_eval_fn(kg, model, tcfg.norm, eval_loop))


def _finish_result(params, history, epochs_run, model,
                   recorder) -> TrainResult:
    if recorder is None:
        return TrainResult(
            params=params, loss_history=history, epochs_run=epochs_run,
            model=model.name)
    return TrainResult(
        params=params, loss_history=history, epochs_run=epochs_run,
        model=model.name, trace=recorder.finalize(),
        best_params=recorder.best_params, best_epoch=recorder.best_epoch)


def epoch_generator(seed: int, epoch: int, stream: int) -> torch.Generator:
    """A CPU generator seeded by (seed, epoch, stream): the port's draws of
    one epoch are a pure function of (seed, epoch)."""
    state = np.random.SeedSequence([seed, epoch, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _own_draws(model, cfg, tcfg, params, pos, head_prob, seed, epoch):
    """The port's own negatives and merge priorities for ``epoch``."""
    neg = model.make_negatives(
        pos, tcfg, head_prob,
        generator=epoch_generator(seed, epoch, _NEGATIVES))
    priorities = None
    if cfg.paradigm == "sgd" and cfg.strategy == "random":
        g = epoch_generator(seed, epoch, _PRIORITIES)
        priorities = {
            name: merge_lib.random_priorities(
                g, cfg.n_workers, params[name].shape[0], pos.device)
            for name in sorted(params)}
    return neg, priorities


def train(
    kg: kg_lib.KG,
    tcfg: KGConfig,
    cfg: MapReduceConfig,
    *,
    epochs: int = 50,
    seed: int = 0,
    params: Optional[Params] = None,
    callback: Optional[Callable[[int, float], None]] = None,
    model: Optional[KGModel] = None,
    device=None,
    draws: Optional[Callable[[int], Draws]] = None,
    eval_loop: Optional[trace_lib.EvalLoopConfig] = None,
    checkpoint: Optional[CheckpointConfig] = None,
    start_epoch: int = 0,
    resume_fresh_init: bool = True,
    prior_history: Optional[list] = None,
) -> TrainResult:
    """Training loop: balanced partitioning, deterministic batches,
    negative sampling, Map/Reduce epochs, loss history.

    Balance rule: the partitioner gives every worker exactly
    ``N // n_workers`` triplets, and each epoch runs ``N_w // batch_size``
    steps per worker; a ``batch_size`` that does not divide ``N_w`` leaves
    the trailing ``N_w % batch_size`` triplets of each worker's per-epoch
    permutation out of that epoch, surfaced as a warning (a ``ValueError``
    under ``cfg.strict_batching``).

    ``params`` (default: the model's init from ``torch.Generator`` seed
    ``seed``) and all training tensors live on ``device`` (default: the
    GPU; raises without one unless ``device="cpu"``).  ``draws(epoch)``,
    when given, returns that epoch's negatives ``(W, S, B, 3)`` and, for
    the ``random`` strategy, each table's merge priorities ``(W, N)`` as
    numpy arrays, in place of the port's own draws.  ``callback(epoch,
    loss)`` fires every epoch.

    In-training evaluation: ``eval_loop`` (a ``trace.EvalLoopConfig``, see
    ``kg.fit(eval_every=...)``) runs the evaluation protocol after every
    ``eval_every``-th epoch and after the last, records a
    ``TrainingTrace`` on the result, keeps the best-metric params and
    stops early on ``patience``.

    Checkpoint/resume: ``checkpoint`` (a :class:`CheckpointConfig`) saves
    params and manifest at epoch boundaries; ``start_epoch=N`` with the
    checkpointed ``params`` resumes a run bit-identically, since batches
    and draws are pure functions of (seed, absolute epoch) — ``draws``
    too is called with absolute epochs.  ``prior_history`` (the
    manifest's loss history) is prepended, so a resumed ``TrainResult``
    matches the unbroken run's.  ``resume_fresh_init`` (whether the
    original run drew its own init) changes nothing here; it is carried
    into later manifests, where the reference's resume needs it to replay
    its key chain.

    ``cfg.n_workers == 1`` reproduces single-thread Algorithm 1 (the
    paper's baseline) for the chosen model."""
    model = _resolve(cfg, model)
    device = resolve_device(device)
    if start_epoch < 0 or (start_epoch and start_epoch >= epochs):
        raise ValueError(
            f"start_epoch={start_epoch} must be in [0, epochs={epochs}) — "
            "resuming a checkpoint at or past the requested epoch count "
            "has nothing left to train; raise epochs")
    partitioned = kg_lib.PARTITIONERS[cfg.partition](
        seed, kg.train, cfg.n_workers)
    n_w = partitioned.shape[1]
    if n_w < cfg.batch_size:
        raise ValueError(
            f"batch_size={cfg.batch_size} exceeds the {n_w} triplets each "
            f"of the {cfg.n_workers} workers holds — zero steps per epoch; "
            "shrink batch_size or n_workers")
    remainder = n_w % cfg.batch_size
    if remainder:
        msg = (
            f"batch_size={cfg.batch_size} does not divide the per-worker "
            f"split of {n_w} triplets — each epoch leaves out the trailing "
            f"{remainder} triplets of every worker's permutation "
            f"({remainder * cfg.n_workers} of {n_w * cfg.n_workers} total); "
            "the per-epoch reshuffle rotates which triplets sit out, so all "
            "of them still train over time.  Pick a batch_size dividing "
            f"{n_w} to use every triplet every epoch.")
        if cfg.strict_batching:
            raise ValueError(msg)
        warn_fresh(msg, stacklevel=2)

    head_prob = None
    if tcfg.sampling == "bern":
        head_prob = torch.as_tensor(
            negative.bernoulli_stats(kg.train, kg.n_relations), device=device)
    caller_params = params is not None
    if params is None:
        params = model.init_params(
            torch.Generator().manual_seed(seed), tcfg, device=device)
    elif set(params) != set(model.param_roles()):
        raise ValueError(
            f"params have tables {sorted(params)} but model "
            f"{model.name!r} expects {sorted(model.param_roles())} — "
            "params from a different model?")
    else:
        params = {name: (p if isinstance(p, torch.Tensor)
                         else torch.tensor(np.asarray(p))).to(
                             device=device, dtype=tcfg.dtype)
                  for name, p in params.items()}

    recorder = _make_recorder(kg, tcfg, model, eval_loop)
    writer = None
    if checkpoint is not None:
        writer = _CheckpointWriter(checkpoint, {
            "kind": "kg_train",
            "model": model.name,
            "seed": seed,
            "paradigm": cfg.paradigm,
            "pipeline": cfg.pipeline,
            "dim": tcfg.dim,
            "n_entities": tcfg.n_entities,
            "n_relations": tcfg.n_relations,
            # whether the ORIGINAL epoch-0 run drew its own init: what the
            # reference's resume replays its key chain by
            "fresh_init": (not caller_params if start_epoch == 0
                           else resume_fresh_init),
            "graph": kg.fingerprint(),
            "config": resume_config(tcfg, cfg),
        })

    epoch_fn = make_epoch_fn(cfg, tcfg, model)
    history = list(prior_history or [])
    epochs_run = epochs
    for epoch in range(start_epoch, epochs):
        pos = torch.as_tensor(
            kg_lib.epoch_batches(seed, epoch, partitioned, cfg.batch_size),
            device=device)
        if draws is None:
            neg, priorities = _own_draws(model, cfg, tcfg, params, pos,
                                         head_prob, seed, epoch)
        else:
            neg_np, pri_np = draws(epoch)
            neg = torch.tensor(np.asarray(neg_np, np.int32), device=device)
            priorities = None if pri_np is None else {
                name: torch.tensor(np.asarray(v), device=device)
                for name, v in pri_np.items()}
        params, loss = epoch_fn(params, pos, neg, priorities)
        loss = float(loss)
        history.append(loss)
        if callback is not None:
            callback(epoch, loss)
        # every epoch ends in a Reduce, so any eval_every lands on a
        # Reduce boundary; the final epoch is always evaluated
        done = epoch + 1
        stop = False
        if recorder is not None and (
            done % eval_loop.eval_every == 0 or done == epochs
        ):
            stop = recorder.record(epoch, done, loss, params)
        if writer is not None and writer.due(done, epochs, stopping=stop):
            writer.save(done, params, history)
        if stop:
            epochs_run = done
            break
    if writer is not None:
        writer.finish()
    return _finish_result(params, history, epochs_run, model, recorder)
