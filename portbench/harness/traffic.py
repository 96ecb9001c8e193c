"""The one generator of every traffic mix, read from its data file.

A serving mix (``"kind": "serve"``) is an open loop (``"loop": "open"``):
evenly spaced arrivals at ``rate_per_s`` over the window, each prompt's
length taken from ``prompt_lengths`` by cycling through a seeded
permutation of them, so every window of a mix holds the same count of each
length and the seed changes only their order and the ids; or a closed loop
(``"loop": "closed"``) of equal waves of ``wave_size`` prompts of each
length in turn.  A training mix (``"kind": "train"``) is ``global_batch``
rows of ``seq_len + 1`` ids a step.  Ids are uniform over the vocabulary,
drawn from (seed, request) or (seed, step), so any one of them can be made
again alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Request", "open_schedule", "closed_wave", "train_rows",
           "prompt_ids"]

_MASK = (1 << 64) - 1


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(w) & _MASK for w in words]))


@dataclass
class Request:
    """One request of an open loop: its index, when it is due (seconds after
    the window opens) and its prompt's length."""

    index: int
    due: float
    length: int


def prompt_ids(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: ``length`` ids, the same for a seed."""
    return _rng(seed, 1, index).integers(0, vocab, length, dtype=np.int64)


def _lengths(traffic: dict, seed: int, n: int) -> list[int]:
    """The first ``n`` prompt lengths: whole blocks of every length once, in
    an order drawn from the seed for each block; a last, partial block
    takes the lengths in the order the mix lists them, so every seed's
    window holds the same lengths."""
    lengths = list(traffic["prompt_lengths"])
    k = len(lengths)
    rng, out = _rng(seed, 0), []
    while len(out) + k <= n:
        out.extend(lengths[i] for i in rng.permutation(k))
    return out + lengths[:n - len(out)]


def open_schedule(traffic: dict, seed: int, seconds: float) -> list[Request]:
    """Every request due in a window of ``seconds``: ``rate_per_s`` evenly
    spaced arrivals from time 0."""
    if traffic["loop"] != "open" or traffic.get("arrival") != "even":
        raise ValueError(f"not an open loop of even arrivals: {traffic}")
    rate = float(traffic["rate_per_s"])
    n = int(np.floor(rate * seconds - 1e-9)) + 1
    return [Request(i, i / rate, length)
            for i, length in enumerate(_lengths(traffic, seed, n))]


def closed_wave(traffic: dict, seed: int, wave: int, vocab: int
                ) -> tuple[list[int], np.ndarray]:
    """Wave ``wave`` of a closed loop: (request indices, prompts (B, T))."""
    if traffic["loop"] != "closed":
        raise ValueError(f"not a closed loop: {traffic}")
    lengths = traffic["prompt_lengths"]
    length = lengths[wave % len(lengths)]
    b = int(traffic["wave_size"])
    idx = list(range(wave * b, (wave + 1) * b))
    return idx, np.stack([prompt_ids(seed, i, length, vocab) for i in idx])


def train_rows(traffic: dict, seed: int, step: int, vocab: int) -> dict:
    """Step ``step``'s batch: ``tokens`` and ``targets`` (B, T) int32, the
    targets the tokens shifted by one."""
    b, t = int(traffic["global_batch"]), int(traffic["seq_len"])
    rows = _rng(seed, 2, step).integers(0, vocab, (b, t + 1),
                                        dtype=np.int64).astype(np.int32)
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
