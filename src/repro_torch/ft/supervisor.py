"""Fault tolerance: supervised restart, straggler detection, failure
injection.

The port of ``repro.ft.supervisor``: the same verdicts, log lines and
restart rules.  A failed step raises; ``Supervisor.run`` restarts the
train function from the latest checkpoint, or from the initial state when
there is none, up to ``max_restarts`` times.  The port's train step
updates its state in place, so ``run`` differs from the reference in two
places:

* it takes a host copy of ``init_state`` at entry and writes it back into
  ``init_state`` for a restart from scratch, which would otherwise start
  from what the failed attempt left there (``snapshot_s`` and
  ``snapshot_bytes`` give the copy's cost);
* it clears the failed attempt's frames (keeping the exception's ``repr``
  in the log) before it restores, so the failed step's tensors are freed
  before a second state is allocated beside the first.

For a state of DTensors the copy is of each rank's local shards, which go
back where they came from (a DTensor on a mesh of cards has no whole
value on one host).
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from ..sharding.context import is_sharded
from ..train.optimizer import tree_leaves

__all__ = ["Supervisor", "StragglerDetector", "FailureInjector",
           "RestartExhausted"]


class RestartExhausted(RuntimeError):
    pass


class FailureInjector:
    """Deterministic failure injection for FT tests: raises at given steps."""

    def __init__(self, fail_at: set[int]):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def __call__(self, step: int, metrics: dict) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclass
class StragglerDetector:
    """Per-step wall-time z-score detector (straggler mitigation hook):
    records and exposes the verdicts."""

    threshold_sigmas: float = 4.0
    window: int = 50
    durations: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self.durations.append(seconds)
        hist = np.asarray(self.durations[-self.window:-1] or [seconds])
        mu, sd = float(np.median(hist)), float(np.std(hist))
        is_straggler = (len(self.durations) > 5
                        and seconds > mu + self.threshold_sigmas * max(sd, 1e-6)
                        and seconds > 1.5 * mu)
        if is_straggler:
            self.flagged.append((step, seconds, mu))
        return is_straggler


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``; of a DTensor, this rank's local shard."""
    return [leaf.to_local() if is_sharded(leaf) else leaf
            for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)]


@torch.no_grad()
def _put_back(tree, copies: list[torch.Tensor]) -> None:
    """Write the host copies back into ``tree``'s tensors (local shards)
    in place."""
    for leaf, saved in zip(_tensors(tree), copies):
        leaf.copy_(saved)


class Supervisor:
    """Run a (restartable) train function, restoring from checkpoints on
    failure. The train function must accept (state, start_step) and honor
    them — the deterministic data pipeline gives a bitwise-identical
    continuation."""

    def __init__(self, checkpointer, max_restarts: int = 3,
                 backoff_s: float = 0.0):
        self.ckpt = checkpointer
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0
        self.log: list[str] = []
        self.snapshot_s = 0.0
        self.snapshot_bytes = 0

    def run(self, train_fn, init_state, state_template=None):
        """train_fn(state, start_step) -> (state, history)."""
        t0 = time.perf_counter()
        initial = [t.detach().to("cpu", copy=True)
                   for t in _tensors(init_state)]
        self.snapshot_s = time.perf_counter() - t0
        self.snapshot_bytes = sum(t.numel() * t.element_size()
                                  for t in initial)
        state, start = init_state, 0
        while True:
            try:
                return train_fn(state, start)
            except Exception as e:  # noqa: BLE001 — any step failure
                self.restarts += 1
                self.log.append(f"failure: {e!r}")
                if self.restarts > self.max_restarts:
                    raise RestartExhausted(
                        f"gave up after {self.max_restarts} restarts") from e
                # free the failed attempt's tensors before a restore
                # allocates a second state
                traceback.clear_frames(e.__traceback__)
            if self.backoff_s:
                time.sleep(self.backoff_s)
            template = state_template if state_template is not None else state
            # A step failure propagates without draining the async writer;
            # join it first so an in-flight save is visible as a restore
            # point instead of being raced past.
            self.ckpt.wait()
            last = self.ckpt.latest_step()
            if last is None:
                _put_back(init_state, initial)
                state, start = init_state, 0
                self.log.append("restart from scratch (no checkpoint)")
            else:
                state, _ = self.ckpt.restore(template, step=last)
                start = last
                self.log.append(f"restart from step {last}")
