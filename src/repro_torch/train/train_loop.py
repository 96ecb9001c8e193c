"""Training loop: a step with microbatch accumulation, remat, metrics and
checkpoint hooks.

The port of ``repro.train.train_loop``, eager (PyTorch has no ``jit`` to
wrap the step in).  ``make_train_step`` builds the (state, batch) ->
(state, metrics) function: the batch (numpy, as ``repro_torch.data``
gives it) goes to the parameters' device (a batch of DTensors, as
``launch.train`` lays it out on a mesh, stays as it is), gradients come
from ``torch.autograd.grad`` through the model's ``train_loss`` (the plain
path, no kernel) in the parameters' placements, and AdamW updates the
state in place; the metrics come back as plain tensors.  With ``microbatches``
> 1 the batch is split strided, as the reference splits it (microbatch i
takes every n-th sequence from i), and the gradients are summed in float32
and averaged.

``train_loop`` feeds ``data.batch_at(step)``, records ``loss``, ``lr``,
``grad_norm`` and ``step_time_s`` (the step's wall time, which waits for
the device), and calls ``straggler.record(step, seconds)``,
``callback(step, metrics)`` and ``checkpointer.save_async(step, state)`` /
``checkpointer.wait()`` as the reference calls them; these are duck-typed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models import Runtime
from ..sharding.context import full, is_sharded
from .optimizer import (OptConfig, apply_updates, init_opt_state,
                        tree_leaves, tree_map)

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_train_state",
           "train_loop"]


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    runtime: Runtime = Runtime()
    ckpt_every: int = 50


TrainState = dict  # {"params": ..., "opt": ...}


def init_train_state(model, seed: int = 0, tc: TrainConfig = TrainConfig(),
                     device: str = "cuda") -> TrainState:
    """Parameters from ``model.init(seed, device)`` (the card unless the
    caller asks for the CPU) and a fresh optimizer state."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": init_opt_state(params, tc.opt)}


def _split_batch(batch: dict, n: int) -> list[dict]:
    """The strided split: microbatch i takes sequences i, i + n, ...  of
    every field (the reference's reshape to (B // n, n) and swap)."""
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"{name}: batch {x.shape[0]} is not divisible "
                             f"by {n} microbatches")
    return [{name: x[i::n] for name, x in batch.items()} for i in range(n)]


def _on_device(batch: dict, device: torch.device) -> dict:
    """Numpy fields to ``device``; tensors there too, DTensors as they
    are."""
    def one(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return x if is_sharded(x) else x.to(device)

    return {name: one(x) for name, x in batch.items()}


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its DTensor parameter's placements (a partial sum is
    reduced here); a plain gradient as it is."""
    if is_sharded(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model, tc: TrainConfig) -> Callable:
    """Returns step(state, batch) -> (state, metrics): the state's
    parameters and optimizer state are updated in place; the metrics
    ``loss``, ``lr`` and ``grad_norm`` are float32 tensors on the
    device."""

    def value_and_grad(params, leaves, mb):
        with torch.enable_grad():
            loss = model.train_loss(params, mb, tc.runtime)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None
                               else _like(g, p)
                               for p, g in zip(leaves, grads)]

    def step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _on_device(batch, leaves[0].device)
        if tc.microbatches > 1:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss_sum = 0.0
            for mb in _split_batch(batch, tc.microbatches):
                loss, grads = value_and_grad(params, leaves, mb)
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
                loss_sum = loss_sum + loss
            loss = loss_sum / tc.microbatches
            flat = [a.div_(tc.microbatches) for a in acc]
        else:
            loss, flat = value_and_grad(params, leaves, batch)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        del flat, it
        params, opt, metrics = apply_updates(params, grads, state["opt"],
                                             tc.opt)
        metrics = {"loss": loss.float(), **metrics}
        return ({"params": params, "opt": opt},
                {name: full(value) for name, value in metrics.items()})

    return step


def train_loop(model, tc: TrainConfig, data, steps: int, *,
               state: TrainState | None = None, start_step: int = 0,
               checkpointer=None, step_fn: Callable | None = None,
               callbacks: list[Callable] | None = None, straggler=None,
               device: str = "cuda"):
    """Host-side loop over steps ``start_step`` .. ``steps - 1``: data
    feed, metrics, periodic asynchronous checkpoints.  A pure function of
    (state, start_step, data), so a restart is deterministic.  Without a
    ``state`` the model is initialised from seed 0 on ``device``.  Returns
    (state, [(step, metrics)])."""
    if state is None:
        state = init_train_state(model, 0, tc, device=device)
    step_fn = step_fn or make_train_step(model, tc)
    history = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch = data.batch_at(step)
        state, metrics = step_fn(state, batch)
        metrics = {name: float(value) for name, value in metrics.items()}
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        history.append((step, metrics))
        if straggler is not None:
            straggler.record(step, dt)
        for cb in callbacks or []:
            cb(step, metrics)
        if checkpointer is not None and (step + 1) % tc.ckpt_every == 0:
            checkpointer.save_async(step + 1, state)
    if checkpointer is not None:
        checkpointer.wait()
    return state, history
