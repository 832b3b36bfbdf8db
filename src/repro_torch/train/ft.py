"""Fault tolerance: supervised restart around the training loop.  A copy
of ``repro.train.ft`` (pure Python).

On a real cluster a node failure kills the process; the scheduler restarts
it and training must resume bit-exactly.  The pieces that make that true
here:
  * checkpoints are atomic + contain (step, params, opt, pipeline state)
    — train/checkpoint.py;
  * data batches are a pure function of (seed, step) — data/tokens.py,
    data/kg.epoch_batches;
  * ``run_with_recovery`` supervises the loop in-process: any exception
    rolls back to the latest committed checkpoint and retries (bounded),
    with a heartbeat file external watchdogs can monitor;
  * in the reference, cross-pod failures need no restart: its MapReduce
    outer merge takes a liveness mask (``repro.core.local_sgd``, not
    ported yet: ROADMAP.md item 16e's rest).

``FailureInjector`` deterministically raises at chosen steps — the tests
use it to prove that a resumed run equals the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class FailureInjector:
    """Raises RuntimeError the first time each listed step is reached."""

    fail_at: tuple = ()
    seen: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def heartbeat(path: str, step: int):
    """Touch a heartbeat file external watchdogs can mtime-check."""
    with open(path, "w") as f:
        f.write(f"{step} {time.time()}\n")


def run_with_recovery(
    make_loop: Callable[[], Callable[[], object]],
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
):
    """Run ``make_loop()()``; on failure rebuild the loop (fresh Trainer,
    which resumes from the latest checkpoint) and retry."""
    attempt = 0
    while True:
        loop = make_loop()
        try:
            return loop()
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — any node fault
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
