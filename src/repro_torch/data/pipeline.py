"""Deterministic, restartable, host-sharded data pipeline.

The port of ``repro.data.pipeline``, numpy as the reference is, with its
seeds and its bundled text, so every batch is bit-equal to the
reference's.  After a crash and restart (or an elastic resize) the
pipeline reproduces exactly the batches the failed run would have seen:
batches are a pure function of (seed, step, host_id), with no iterator
state to lose.  Tokens come from a counter-mode generator (synthetic LM
data) or a bundled byte corpus.  Batches stay numpy; the train step moves
them to the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "ByteCorpus"]

_TEXT = (
    "MT4G discovers GPU compute and memory topologies with over fifty "
    "microbenchmarks and a Kolmogorov-Smirnov change point detector. "
    "Understanding which memory elements exist, their sizes, latencies and "
    "bandwidths, and where they sit in the chip topology is the first step "
    "of every serious performance engineering effort. "
) * 64


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    n_codebooks: int = 0          # audio family
    n_patches: int = 0            # vlm family
    vision_embed_dim: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} is not a "
                             f"multiple of {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Counter-mode synthetic next-token data: batch_at(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_id]))

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = self._rng(step)
        b = c.host_batch
        if c.n_codebooks:
            toks = rng.integers(0, c.vocab_size,
                                (b, c.n_codebooks, c.seq_len + 1))
            return {"tokens": toks[..., :-1].astype(np.int32),
                    "targets": toks[..., 1:].astype(np.int32)}
        toks = rng.integers(0, c.vocab_size, (b, c.seq_len + 1))
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "targets": toks[:, 1:].astype(np.int32)}
        if c.n_patches:
            out["patches"] = rng.normal(
                0, 1, (b, c.n_patches, c.vision_embed_dim)).astype(np.float32)
        return out


class ByteCorpus:
    """Byte-level LM over a bundled corpus — a learnable task for the
    end-to-end training example (loss should drop well below ln(256))."""

    def __init__(self, cfg: DataConfig, text: str = _TEXT):
        self.cfg = cfg
        data = np.frombuffer(text.encode(), dtype=np.uint8)
        reps = int(np.ceil((cfg.seq_len + 1) * cfg.global_batch * 4
                           / data.size)) + 1
        self.data = np.tile(data, reps)

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id, 7]))
        b = c.host_batch
        starts = rng.integers(0, self.data.size - c.seq_len - 1, b)
        rows = np.stack([self.data[s: s + c.seq_len + 1] for s in starts])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "targets": rows[:, 1:].astype(np.int32)}
