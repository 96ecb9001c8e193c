"""Training launcher: train a model from a seed under the supervisor, with
periodic checkpoints, a straggler detector and resume.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch internlm2-1.8b-smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 50 --seq 64 --global-batch 8 --remat full

The port of ``repro.launch.train`` on one card: ``--mesh`` takes only
``1x1`` (``sharding/`` is not ported), the process is the only host, and
the step runs eagerly and updates the state in place (no ``jit``, no
donation).  As in the reference: AdamW at ``--lr`` with 10 warmup steps
and a cosine to ``--steps``, ``ByteCorpus`` batches, seed-0 parameters, a
checkpoint every 50 steps under ``--ckpt-dir`` and up to 3 restarts.
``--resume`` restores the latest checkpoint and trains on from its step
(the reference restores it, then trains from step 0 again).  ``main``
returns its numbers and the final state as well as printing the
``[train]`` line.
"""
import argparse

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import ByteCorpus, DataConfig
from ..ft import StragglerDetector, Supervisor
from ..models import Runtime, get_model
from ..train import (OptConfig, TrainConfig, init_train_state,
                     make_train_step, train_loop)

__all__ = ["main"]


def main(argv=None) -> dict:
    """Train and return ``{"arch", "steps", "losses", "restarts",
    "stragglers", "ckpt_steps", "start", "state", "supervisor",
    "checkpointer"}``: ``steps`` counts the steps this run took, from
    ``start``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data x model mesh shape; only 1x1")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: sharding/ is not "
                                  f"ported; the port trains on one card "
                                  f"(1x1)")

    cfg = get_config(args.arch)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=10,
                                   total_steps=args.steps),
                     microbatches=args.microbatches,
                     runtime=Runtime(remat=args.remat), ckpt_every=50)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq,
                                 global_batch=args.global_batch))
    state = init_train_state(model, 0, tc, device=args.device)
    step_fn = make_train_step(model, tc)
    ck = Checkpointer(args.ckpt_dir)
    straggler = StragglerDetector()

    start = 0
    if args.resume and ck.latest_step() is not None:
        state, _ = ck.restore(state)
        start = ck.latest_step()
        print(f"resumed from step {start}")

    def train_fn(st, st_step):
        return train_loop(model, tc, data, steps=args.steps, state=st,
                          start_step=max(st_step, start), checkpointer=ck,
                          step_fn=step_fn, straggler=straggler)

    sup = Supervisor(ck, max_restarts=3)
    state, hist = sup.run(train_fn, state)

    losses = [mtr["loss"] for _, mtr in hist]
    print(f"[train] arch={cfg.name} mesh={args.mesh} steps={len(hist)} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"restarts={sup.restarts} stragglers={len(straggler.flagged)}")
    return {"arch": cfg.name, "steps": len(hist), "losses": losses,
            "restarts": sup.restarts, "stragglers": list(straggler.flagged),
            "ckpt_steps": ck.steps(), "start": start, "state": state,
            "supervisor": sup, "checkpointer": ck}


if __name__ == "__main__":
    main()
