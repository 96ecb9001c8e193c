"""The training window over the port's ``make_train_step``.

Set-up builds one train step with its model and optimizer state from the
seed and drives it through the first ``checked_steps`` steps, on the
window's own feed and call, reading what the check compares: each step's
loss, each leaf's first gradient as the optimizer took it (its first
moment after one step, over 1 - b1) and each leaf's change after the last
of them.  The same state then runs the window: steps back to back, which
closes at the end of the step running when ``seconds`` have passed, so no
step is counted in part.  ``fault`` plants a fault underneath the timed
path, for the tests that show the check catches it.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from .traffic import train_rows
from .weights import make_params, named_initial

__all__ = ["TrainResult", "Trainer", "named_leaves"]


@dataclass
class TrainResult:
    steps: int = 0
    tokens: int = 0
    window_s: float = 0.0
    failed: int = 0

    @property
    def attempted(self) -> int:
        return self.steps


def named_leaves(tree: dict) -> dict:
    """A parameter tree's leaves by name: ``embed``, ``head``,
    ``final_norm``, ``layers.<i>.<name>``."""
    out = {n: tree[n] for n in ("embed", "head", "final_norm")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{n}": t for n, t in layer.items()})
    return out


class Trainer:
    """One train step of the port, its state made from the seed."""

    def __init__(self, shape, traffic: dict, seed: int, device,
                 fault=None):
        from repro_torch.models import Runtime, get_model
        from repro_torch.train import OptConfig, TrainConfig
        from repro_torch.train.optimizer import init_opt_state
        from repro_torch.train.train_loop import make_train_step

        from .spec import port_config

        self.shape, self.traffic, self.seed = shape, traffic, seed
        self.device = device
        self.opt = dict(traffic["optimizer"])
        tc = TrainConfig(opt=OptConfig(**self.opt),
                         microbatches=int(traffic["microbatches"]),
                         runtime=Runtime(remat=traffic["remat"]))
        self.model = get_model(port_config(shape))
        params = make_params(shape, seed, device)
        self.state = {"params": params,
                      "opt": init_opt_state(params, tc.opt)}
        step = make_train_step(self.model, tc)
        self.step_fn = self._faulty(step, tc, fault) if fault else step
        self.next_step = 0

    def _faulty(self, step, tc, fault):
        if fault == "half_batch":
            def half(state, batch):
                n = batch["tokens"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
            return half
        if fault == "unchanged":
            def unchanged(state, batch):
                dev = {k: torch.as_tensor(v, device=self.device)
                       for k, v in batch.items()}
                with torch.no_grad():
                    loss = self.model.train_loss(state["params"], dev,
                                                 tc.runtime)
                return state, {"loss": loss.float()}
            return unchanged
        raise ValueError(f"unknown fault {fault!r}")

    def step(self) -> float:
        """One step on the next batch of the feed -> its loss (which waits
        for the device)."""
        batch = train_rows(self.traffic, self.seed, self.next_step,
                           self.shape.vocab)
        self.state, metrics = self.step_fn(self.state, batch)
        self.next_step += 1
        return float(metrics["loss"])

    @torch.no_grad()
    def checked_steps(self) -> dict:
        """The first ``checked_steps`` steps and the program's readings."""
        b1 = self.opt["b1"]
        losses, grad = [], None
        for _ in range(int(self.traffic["checked_steps"])):
            losses.append(self.step())
            if grad is None:
                m = named_leaves(self.state["opt"]["m"])
                grad = {n: float(t.norm()) / (1 - b1) for n, t in m.items()}
        opt = self.state["opt"]
        master = named_leaves(opt.get("master", self.state["params"]))
        init = named_initial(self.shape, self.seed, self.device)
        change = {n: float((t.float() - init[n].float()).norm())
                  for n, t in master.items()}
        return {"loss": losses, "grad": grad, "change": change}

    def window(self, seconds: float, tracer,
               clock=time.perf_counter) -> TrainResult:
        res = TrainResult()
        b, t = int(self.traffic["global_batch"]), \
            int(self.traffic["seq_len"])
        t0 = clock()
        while True:
            loss = self.step()
            tracer.mark("train_step", kind="train", batch=b, seq=t)
            now = clock()
            res.steps += 1
            res.failed += not math.isfinite(loss)
            if now - t0 >= seconds:
                break
        res.tokens = res.steps * b * t
        res.window_s = now - t0
        return res
