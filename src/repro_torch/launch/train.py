"""Training launcher: train a model from a seed under the supervisor, with
periodic checkpoints, a straggler detector and resume, on a device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch internlm2-1.8b-smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 50 --seq 64 --global-batch 8 --remat full
    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch internlm2-1.8b-smoke --mesh 2x2 --device cpu

The port of ``repro.launch.train``.  ``--mesh DxM`` is a (data, model)
``DeviceMesh`` over the ranks of ``torchrun``'s process group (``gloo`` on
the CPU, ``nccl`` on the card; a one-device mesh with no ``torchrun``
makes a group of one itself), and its size must equal the world size.
The state is laid out on it by ``sharding.TRAIN_RULES`` at every mesh
size, ``1x1`` included: every rank draws the seed-0 state whole and keeps
its own shards.  Every rank reads the whole global batch from
``ByteCorpus`` and keeps the rows ``batch_spec`` gives it, so a run's
losses do not depend on the mesh.  The step runs eagerly inside
``activation_sharding(mesh, TRAIN_RULES)`` and updates the state in place
(no ``jit``, no donation).  As in the reference: AdamW at ``--lr`` with 10
warmup steps and a cosine to ``--steps``, seed-0 parameters, a checkpoint
every 50 steps under ``--ckpt-dir`` (rank 0 writes) and up to 3 restarts.
``--resume`` restores the latest checkpoint onto the mesh and trains on
from its step (the reference restores it, then trains from step 0 again).
``main`` returns its numbers, the mesh and the final state as well as
printing the ``[train]`` line (rank 0).
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import ByteCorpus, DataConfig
from ..ft import StragglerDetector, Supervisor
from ..models import Runtime, get_model
from ..sharding import TRAIN_RULES, activation_sharding, tree_shardings
from ..sharding.context import distribute
from ..sharding.specs import batch_spec, placements
from ..train import (OptConfig, TrainConfig, init_train_state,
                     make_train_step, train_loop)
from ..train.optimizer import opt_state_specs
from .mesh import init_process_group, make_mesh, parse_mesh

__all__ = ["main"]


def main(argv=None) -> dict:
    """Train and return ``{"arch", "steps", "losses", "step_s", "restarts",
    "stragglers", "ckpt_steps", "start", "state", "supervisor",
    "checkpointer", "mesh", "step_fn"}``: ``steps`` counts the steps this
    run took, from ``start``; ``step_s`` their walls; ``step_fn(state,
    batch)`` is the run's step (a numpy batch laid out on the mesh, the
    step inside the activation-sharding context)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data x model mesh shape; D*M ranks")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    d, m = parse_mesh(args.mesh)
    device_type = torch.device(args.device).type
    init_process_group(device_type, d * m)
    mesh = make_mesh((d, m), ("data", "model"), device_type)

    cfg = get_config(args.arch)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=10,
                                   total_steps=args.steps),
                     microbatches=args.microbatches,
                     runtime=Runtime(remat=args.remat), ckpt_every=50)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq,
                                 global_batch=args.global_batch))

    # Sharded state: TRAIN_RULES onto the mesh for params + opt.
    state = init_train_state(model, 0, tc, device=args.device)
    pspecs = model.param_specs()
    logical = {"params": pspecs,
               "opt": opt_state_specs(pspecs, tc.opt,
                                      has_master="master" in state["opt"])}
    state = distribute(state, tree_shardings(state, logical, TRAIN_RULES,
                                             mesh))
    device = state["opt"]["step"].device

    def on_mesh(batch):
        """The global batch's rows of this rank, by ``batch_spec``."""
        out = {}
        for name, x in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            spec = batch_spec(tuple(t.shape), TRAIN_RULES, mesh)
            out[name] = distribute(t, (mesh, placements(spec, mesh)))
        return out

    train_step = make_train_step(model, tc)

    def step_fn(st, batch):
        with activation_sharding(mesh, TRAIN_RULES):
            return train_step(st, on_mesh(batch))

    ck = Checkpointer(args.ckpt_dir)
    straggler = StragglerDetector()

    start = 0
    if args.resume and ck.latest_step() is not None:
        state, _ = ck.restore(state)
        start = ck.latest_step()
        if dist.get_rank() == 0:
            print(f"resumed from step {start}")

    def train_fn(st, st_step):
        return train_loop(model, tc, data, steps=args.steps, state=st,
                          start_step=max(st_step, start), checkpointer=ck,
                          step_fn=step_fn, straggler=straggler)

    sup = Supervisor(ck, max_restarts=3)
    state, hist = sup.run(train_fn, state)

    losses = [mtr["loss"] for _, mtr in hist]
    if dist.get_rank() == 0:
        print(f"[train] arch={cfg.name} mesh={args.mesh} steps={len(hist)} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"restarts={sup.restarts} stragglers={len(straggler.flagged)}")
    return {"arch": cfg.name, "steps": len(hist), "losses": losses,
            "restarts": sup.restarts, "stragglers": list(straggler.flagged),
            "step_s": [mtr["step_time_s"] for _, mtr in hist],
            "ckpt_steps": ck.steps(), "start": start, "state": state,
            "supervisor": sup, "checkpointer": ck, "mesh": mesh,
            "step_fn": step_fn}


if __name__ == "__main__":
    main()
