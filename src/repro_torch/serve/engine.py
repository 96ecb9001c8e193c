"""Token-serving engine: batched prefill + decode over a slot pool.

The port of ``repro.serve.engine``, eager (PyTorch has no ``jit`` to wrap
the steps in).  The engine owns a fixed pool of B sequence slots.
``serve`` groups equal-length prompts into slot-sized waves; each wave is
one prefill (the model's kernels run here) and then one decode step per
new token for all its slots at once.  Greedy sampling takes the argmax of
the logits on the device; temperature sampling draws on the host from a
seeded numpy generator, as the reference does.

A request is what the family's prefill takes for one sequence: a (T,)
array of token ids (dense, moe, ssm, hybrid), a (K, T) array of codebook
ids (audio), or ``{"patches": (P, vision_embed_dim), "tokens": (T,)}``
(vlm).  A wave stacks each field.  An audio decode step feeds the sampled
frame as (B, K, 1), one token a codebook, and each codebook is sampled on
its own.  The engine is held to a loop of the model's ``prefill`` and
``decode_step`` with the batch layouts of the reference's
``Model.input_specs``, not to the reference's ``Engine``, which feeds an
audio step (B, 1, K).

``stats`` accumulates the seconds spent in prefill and in decode (each
ending where the sampled tokens reach the host, which waits for the
device) and the counts of both.  Each prefill and each decode step runs
under a ``torch.profiler.record_function`` span (``serve.prefill``,
``serve.decode_step``) that also ends there, so a trace splits the device's
time between the two by the spans' windows.

Parameters may be DTensors (``launch.serve --mesh``): the batches and the
cache then live on the parameters' mesh, replicated, the steps run with
plain tensors counted as replicated (``sharding.context.on_mesh``), and
the logits are gathered whole before sampling.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from ..sharding.context import full, on_mesh, replicate_like

__all__ = ["ServeConfig", "Engine", "stack"]


def stack(requests: list):
    """Requests of one wave -> the wave: the arrays stacked on a new first
    axis, or for vlm's requests a dictionary of each field stacked."""
    if isinstance(requests[0], dict):
        return {name: np.stack([np.asarray(r[name]) for r in requests])
                for name in requests[0]}
    return np.stack(requests)


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs: slot-pool size, sequence cap, sampling temperature,
    and the device the parameters live on."""

    max_len: int = 256
    slots: int = 4
    temperature: float = 0.0        # 0 -> greedy
    device: str = "cuda"


class Engine:
    """Token server over a fixed slot pool; ``generate_batch`` prefills a
    wave and decodes all its slots per step."""

    def __init__(self, model, params, cfg: ServeConfig):
        where = params["embed"].device
        if where.type != torch.device(cfg.device).type:
            raise ValueError(f"parameters on {where}, ServeConfig.device is "
                             f"{cfg.device!r}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = where
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "prefills": 0,
                      "decode_steps": 0}

    def _sample(self, logits: torch.Tensor,
                rng: np.random.Generator) -> np.ndarray:
        """Logits (B, V), or audio's (B, K, V) -> ids (B,) or (B, K): the
        argmax over the last axis, or a draw for each row of the last axis
        in order (b, then k) from ``rng``."""
        logits = full(logits)
        if self.cfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        z = logits.float().cpu().numpy() / self.cfg.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        rows = p.reshape(-1, p.shape[-1])
        return np.array([rng.choice(p.shape[-1], p=row)
                         for row in rows]).reshape(p.shape[:-1])

    def _on_mesh(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the parameters' mesh, replicated, where they have one."""
        return replicate_like(t, self.params["embed"])

    def _tokens(self, ids: np.ndarray) -> torch.Tensor:
        return self._on_mesh(torch.as_tensor(np.asarray(ids, np.int64),
                                             device=self.device))

    def _batch(self, prompts) -> dict:
        """A wave's stacked prompts -> the prefill's batch on the device:
        ids, or vlm's patches (in the projection's dtype) and ids."""
        if not isinstance(prompts, dict):
            return {"tokens": self._tokens(prompts)}
        proj = self.params["vis_proj"]
        patches = torch.as_tensor(np.asarray(prompts["patches"]),
                                  device=self.device).to(proj.dtype)
        return {"patches": self._on_mesh(patches),
                "tokens": self._tokens(prompts["tokens"])}

    @torch.no_grad()
    def generate_batch(self, prompts, max_new: int,
                       eos_id: int | None = None,
                       seed: int = 0) -> np.ndarray:
        """One batch of same-length prompts, stacked as ``serve`` stacks a
        wave -> (B, <=max_new) generations, or (B, <=max_new, K) for audio.
        With ``eos_id`` the wave stops once every sequence has sampled it
        (audio: in every codebook of a frame)."""
        with on_mesh():
            return self._generate(prompts, max_new, eos_id, seed)

    def _generate(self, prompts, max_new: int, eos_id: int | None,
                  seed: int) -> np.ndarray:
        if max_new < 1:
            raise ValueError(f"max_new must be at least 1, got {max_new}")
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        with record_function("serve.prefill"):
            logits, cache = self.model.prefill(
                self.params, self._batch(prompts), self.cfg.max_len)
            outs = [self._sample(logits, rng)]
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefills"] += 1
        alive = np.ones(outs[0].shape[0], bool)
        while len(outs) < max_new:
            if eos_id is not None:
                ended = outs[-1] == eos_id
                alive &= ~ended.reshape(len(alive), -1).all(-1)
                if not alive.any():
                    break
            t0 = time.perf_counter()
            with record_function("serve.decode_step"):
                step = {"tokens": self._tokens(outs[-1][..., None])}
                logits, cache = self.model.decode_step(self.params, step,
                                                       cache)
                outs.append(self._sample(logits, rng))
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
        return np.stack(outs, axis=1)

    def serve(self, requests: list, max_new: int,
              seed: int = 0) -> list[np.ndarray]:
        """Serve a request queue in slot-sized waves of equal-length
        prompts; each result is (new,), or (new, K) for audio."""
        results: dict[int, np.ndarray] = {}
        queue = list(enumerate(requests))
        while queue:
            wave = queue[: self.cfg.slots]
            queue = queue[self.cfg.slots:]
            prompts = stack([p for _, p in wave])
            gen = self.generate_batch(prompts, max_new, seed=seed)
            for j, (i, _) in enumerate(wave):
                results[i] = gen[j]
        return [results[i] for i in range(len(requests))]
