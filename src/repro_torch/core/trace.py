"""Training observability: quality-vs-epoch traces from inside ``fit``
(port of ``repro.core.trace``).

``kg.fit(..., eval_every=K)`` runs the paper's evaluation protocol at
Reduce boundaries *during* training and returns a :class:`TrainingTrace`
on the ``TrainResult``: the quality each Reduce retains, as the paper's
claim is stated.

Pieces:

  * :class:`EvalLoopConfig` — what to evaluate, how often, and when to
    stop: ``eval_every`` (epochs between in-loop evaluations; the host
    pipeline Reduces every epoch, so any value is a Reduce boundary),
    ``metric`` (a dotted spec into the ``evaluate_all`` output, e.g.
    ``"entity_filtered.mean_rank"``), ``patience`` (stop after that many
    consecutive non-improving evaluations), ``engine`` + ``engine_kw``
    (which evaluation engine scores the boundary — ``"device"`` by
    default), ``keep_best`` (snapshot the best-metric params).
  * :class:`TraceRecorder` — the accumulator ``core/mapreduce.train``
    calls at each boundary: wall clock, best-metric bookkeeping, early
    stopping, best-params snapshots (cloned, so later training steps
    cannot change them).
  * :class:`TrainingTrace` / :class:`TraceEntry` — the result: per
    boundary (epoch, merge round, loss, wall-clock seconds, full metrics
    dict), written as JSONL by :meth:`TrainingTrace.to_jsonl` with the
    reference's keys.

The in-loop metrics are exactly the numbers a later ``kg.evaluate`` of
the same params gives: the evaluation runs under ``torch.no_grad()`` on
the boundary params and draws none of the random numbers training uses.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import eval as kg_eval

# metric leaves where smaller is better; everything else (mrr, hits@k,
# triplet_classification_acc) improves upward
_LOWER_IS_BETTER = ("mean_rank",)


def metric_value(metrics: Dict, spec: str) -> float:
    """Resolve a dotted metric spec against an ``evaluate_all`` output dict.

    ``"entity_filtered.mean_rank"`` walks ``metrics["entity_filtered"]
    ["mean_rank"]``; ``"triplet_classification_acc"`` reads the top-level
    float.  Raises ``KeyError`` naming the available keys on a miss and
    ``ValueError`` when the spec stops at a whole metric row."""
    node = metrics
    for part in spec.split("."):
        if not isinstance(node, dict) or part not in node:
            have = sorted(node) if isinstance(node, dict) else type(node)
            raise KeyError(
                f"metric spec {spec!r}: no key {part!r} (available: {have})")
        node = node[part]
    if isinstance(node, dict):
        raise ValueError(
            f"metric spec {spec!r} resolves to a whole row "
            f"({sorted(node)}) — pick a leaf, e.g. {spec}.mean_rank")
    return float(node)


def metric_mode(spec: str) -> str:
    """'min' | 'max': which direction of ``spec`` is an improvement."""
    return "min" if spec.split(".")[-1] in _LOWER_IS_BETTER else "max"


@dataclasses.dataclass(frozen=True)
class EvalLoopConfig:
    """In-training evaluation schedule (see the module docstring).

    ``patience`` stops training after that many consecutive evaluations
    without a strict improvement of ``metric`` (None disables early
    stopping).  The final epoch is always evaluated, so the trace ends on
    the run's last params."""

    eval_every: int
    metric: str = "entity_filtered.mean_rank"
    patience: Optional[int] = None
    engine: str = "device"
    filtered: bool = True
    engine_kw: Dict = dataclasses.field(default_factory=dict)
    keep_best: bool = True

    def __post_init__(self):
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")
        if self.patience is not None and self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if not self.filtered and self.metric.startswith("entity_filtered"):
            raise ValueError(
                f"metric {self.metric!r} needs filtered=True — the filtered "
                "entity row is not computed otherwise")


@dataclasses.dataclass
class TraceEntry:
    """One in-loop evaluation: the state of the run at a Reduce boundary."""

    epoch: int              # 0-based index of the last epoch completed
    merge_round: int        # Reduce rounds completed so far
    loss: float             # training loss of that epoch
    wall_clock: float       # seconds since training started
    metrics: Dict           # full evaluate_all output dict

    def as_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "merge_round": self.merge_round,
            "loss": self.loss,
            "wall_clock": self.wall_clock,
            "metrics": self.metrics,
        }


@dataclasses.dataclass
class TrainingTrace:
    """Quality-vs-epoch curve of one training run."""

    entries: List[TraceEntry]
    eval_every: int
    metric: str
    best_epoch: Optional[int] = None
    best_value: Optional[float] = None
    stopped_early: bool = False

    def values(self, spec: Optional[str] = None) -> List[float]:
        """The curve of ``spec`` (default: the configured metric) across
        entries."""
        spec = spec or self.metric
        return [metric_value(e.metrics, spec) for e in self.entries]

    def epochs(self) -> List[int]:
        return [e.epoch for e in self.entries]

    def best(self) -> Optional[TraceEntry]:
        for e in self.entries:
            if e.epoch == self.best_epoch:
                return e
        return None

    def to_jsonl(self, path: str) -> None:
        """One JSON object per boundary evaluation, in epoch order."""
        with open(path, "w") as f:
            for e in self.entries:
                f.write(json.dumps(e.as_dict(), sort_keys=True))
                f.write("\n")


def make_eval_fn(
    kg, model, norm: str, cfg: EvalLoopConfig
) -> Callable[[Dict], Dict]:
    """The boundary evaluator: the full ``evaluate_all`` protocol on the
    current params with the configured engine, so every trace entry is
    what a later ``kg.evaluate`` of the same params returns."""

    def eval_fn(params):
        with torch.no_grad():
            return kg_eval.evaluate_all(
                params, kg, norm=norm, filtered=cfg.filtered, model=model,
                engine=cfg.engine, **cfg.engine_kw)

    return eval_fn


class TraceRecorder:
    """Accumulates boundary evaluations for one training run (one per
    ``train`` call — owns the wall-clock origin and the early-stopping
    state)."""

    def __init__(self, cfg: EvalLoopConfig, eval_fn: Callable[[Dict], Dict]):
        self.cfg = cfg
        self._eval_fn = eval_fn
        self._mode = metric_mode(cfg.metric)
        self._t0 = time.perf_counter()
        self._stale = 0
        self.entries: List[TraceEntry] = []
        self.best_epoch: Optional[int] = None
        self.best_value: Optional[float] = None
        self.best_params = None
        self.stopped_early = False

    def _improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        if self._mode == "min":
            return value < self.best_value
        return value > self.best_value

    def record(self, epoch: int, merge_round: int, loss: float, params) -> bool:
        """Evaluate ``params`` after ``epoch`` and append an entry.

        Returns True when the early-stopping budget is exhausted (the
        caller stops training).  The best params are cloned: the caller
        may go on training the tensors it passed."""
        metrics = self._eval_fn(params)
        value = metric_value(metrics, self.cfg.metric)
        self.entries.append(TraceEntry(
            epoch=epoch, merge_round=merge_round, loss=loss,
            wall_clock=time.perf_counter() - self._t0, metrics=metrics))
        if self._improved(value):
            self.best_epoch, self.best_value = epoch, value
            self._stale = 0
            if self.cfg.keep_best:
                self.best_params = {name: t.detach().clone()
                                    for name, t in params.items()}
        else:
            self._stale += 1
        if self.cfg.patience is not None and self._stale >= self.cfg.patience:
            self.stopped_early = True
            return True
        return False

    def finalize(self) -> TrainingTrace:
        return TrainingTrace(
            entries=self.entries,
            eval_every=self.cfg.eval_every,
            metric=self.cfg.metric,
            best_epoch=self.best_epoch,
            best_value=self.best_value,
            stopped_early=self.stopped_early,
        )
