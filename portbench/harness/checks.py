"""What decides ``correct``: the program's outputs against the plain
reference (``portbench/reference``), each number held to its limit.

* Serving: a sample drawn from the seed of the finished requests, one
  with the longest sequence always in it.  The reference runs each prompt
  with its served ids once, and ``logit_gap`` is the widest gap by which a
  served id's logit lies below the reference's best at its position.  The
  control (``fp8``) reads, at each of the same positions, the gap of the id
  the float8 reference puts first.
* Training: ``loss_gap``, the largest relative gap of a checked step's
  loss; ``grad_gap``, the worst leaf's gap between the norms of the first
  gradient as the optimizer took it; ``update_gap``, the worst leaf's gap
  between the norms of the change after the checked steps.  A leaf's gap is
  taken against the reference's norm of that leaf or of the median leaf,
  whichever is larger; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out of the change (they move by
  the optimizer's round-off alone).
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

__all__ = ["sample_requests", "serve_gaps", "train_numbers", "judge"]


def sample_requests(finished: dict, seed: int, n: int) -> list:
    """Up to ``n`` finished request indices drawn from the seed, one with
    the longest sequence (prompt and served ids; drawn from the seed among
    equals) among them."""
    idx = sorted(finished)
    if not idx:
        return []
    size = {i: len(finished[i][0]) + len(finished[i][1]) for i in idx}
    top = [i for i in idx if size[i] == max(size.values())]
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & ((1 << 64) - 1), 3]))
    longest = top[int(rng.integers(len(top)))]
    rest = [i for i in idx if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def serve_gaps(shape, seed: int, finished: dict, picked: list, device,
               control: bool = False) -> dict:
    """``logit_gap`` of the served ids at the picked requests (and, with
    ``control``, ``control_logit_gap``, the float8 reference's)."""
    from reference.dense import serve_logits

    seqs, starts, served = [], [], []
    for i in picked:
        prompt, ids = finished[i]
        seqs.append(torch.as_tensor(np.concatenate([prompt, ids[:-1]]),
                                    dtype=torch.long))
        starts.append(len(prompt))
        served.append(torch.as_tensor(ids, dtype=torch.long, device=device))
    ref = serve_logits(shape, seed, seqs, starts, device)
    out = {"logit_gap": _widest(ref, served)}
    if control:
        low = serve_logits(shape, seed, seqs, starts, device, fp8=True)
        out["control_logit_gap"] = _widest(ref,
                                           [lg.argmax(-1) for lg in low])
    return out


def _widest(ref: list, ids: list) -> float:
    worst = 0.0
    for logits, want in zip(ref, ids):
        got = logits.gather(-1, want[:, None])[:, 0]
        worst = max(worst, float((logits.max(-1).values - got).max()))
    return worst


def _leaf_gap(prog: dict, ref: dict, names) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """The three training numbers of the program's readings against the
    reference's (each ``{"loss": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}}``)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], names),
            "update_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit -> (every number within its limit and
    finite, {name: {"value", "limit"}})."""
    table, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value == value \
            and value <= limit
    return ok, table
