"""AdamW with a warmup and cosine schedule and global-norm clipping.

The port of ``repro.train.optimizer`` on the port's parameter trees
(dictionaries and the per-layer list of dictionaries).  The moments are
float32; a float32 master copy is kept only when some parameter is not
float32, and the update is taken on it, then cast back to the parameter's
dtype.  The arithmetic follows the reference's order (the clip scale, the
moments, the bias corrections, the decoupled weight decay on the master),
each step on whole tensors under ``torch.no_grad()``; parameters, moments
and master are updated in place, which gives the same values as the
reference's new arrays and holds no second copy of the state.

The leaves may be DTensors (``launch.train`` lays the state out by
``sharding.TRAIN_RULES``): each moment and the master keep their
parameter's placements (``opt_state_specs`` mirrors its axes), the
gradients are taken in the parameters' placements, and ``global_norm``
reduces every sharded leaf to a whole scalar before the clip scale is
formed, so no partial sum reaches the update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..sharding.context import full, on_mesh, replicate_like

__all__ = ["OptConfig", "init_opt_state", "opt_state_specs", "apply_updates",
           "lr_at", "global_norm", "tree_leaves", "tree_map"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_f32: bool = True


def tree_leaves(tree) -> list:
    """The tensors of a tree of dictionaries and lists, in its order."""
    if isinstance(tree, dict):
        return [leaf for sub in tree.values() for leaf in tree_leaves(sub)]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of ``rest``,
    which share its structure -> a tree of that structure."""
    if isinstance(tree, dict):
        return {name: tree_map(fn, sub, *(r[name] for r in rest))
                for name, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, sub, *(r[i] for r in rest))
                for i, sub in enumerate(tree)]
    return fn(tree, *rest)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a float32
    tensor: linear warmup to ``lr``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _needs_master(params) -> bool:
    return any(leaf.dtype != torch.float32 for leaf in tree_leaves(params))


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero float32 moments shaped as ``params``, the step (an int32
    tensor on the parameters' device) and, when ``cfg.master_f32`` and some
    parameter is not float32, a float32 master copy."""
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = tree_leaves(params)[0]
    with torch.no_grad():
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        state = {"m": tree_map(zeros32, params),
                 "v": tree_map(zeros32, params),
                 "step": replicate_like(step, first)}
        # for float32 parameters the master would be a second copy of them
        if cfg.master_f32 and _needs_master(params):
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def opt_state_specs(param_specs_tree, cfg: OptConfig,
                    has_master: bool = True) -> dict:
    """The logical-axis tree of the optimizer state, mirroring the
    parameters' (leaves are tuples of axis names)."""
    def copy(tree):
        if isinstance(tree, dict):
            return {name: copy(sub) for name, sub in tree.items()}
        if isinstance(tree, list):
            return [copy(sub) for sub in tree]
        return tree

    state = {"m": copy(param_specs_tree), "v": copy(param_specs_tree),
             "step": ()}
    if cfg.master_f32 and has_master:
        state["master"] = copy(param_specs_tree)
    return state


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf of ``tree`` taken together, a plain
    tensor: a DTensor leaf's sum of squares is reduced over its mesh
    first."""
    leaves = [full(torch.sum(torch.square(leaf.float())))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step -> (params, state, metrics ``lr`` and ``grad_norm``,
    float32 tensors).  ``params`` and the state's moments and master are
    updated in place and returned; ``grads`` (the parameters' layout, any
    float dtype) are read."""
    with on_mesh():
        return _apply_updates(params, grads, state, cfg)


def _apply_updates(params, grads, state: dict, cfg: OptConfig):
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    masters = state.get("master", params)
    for p, pm, g, m, v in zip(*(tree_leaves(t) for t in (
            params, masters, grads, state["m"], state["v"]))):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        pm32 = pm if pm.dtype == torch.float32 else pm.float()
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        update.add_(cfg.weight_decay * pm32)
        pm32.sub_(lr * update)
        if pm32 is not p:
            p.copy_(pm32)
    new_state = dict(state, step=step)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
