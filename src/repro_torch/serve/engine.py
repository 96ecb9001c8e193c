"""Token-serving engine: batched prefill + decode over a slot pool.

The port of ``repro.serve.engine``, eager (PyTorch has no ``jit`` to wrap
the steps in).  The engine owns a fixed pool of B sequence slots.
``serve`` groups equal-length prompts into slot-sized waves; each wave is
one prefill (the model's kernels run here) and then one decode step per
new token for all its slots at once.  Greedy sampling takes the argmax of
the logits on the device; temperature sampling draws on the host from a
seeded numpy generator, as the reference does.

``stats`` accumulates the seconds spent in prefill and in decode (each
ending where the sampled tokens reach the host, which waits for the
device) and the counts of both.  Each prefill and each decode step runs
under a ``torch.profiler.record_function`` span (``serve.prefill``,
``serve.decode_step``) that also ends there, so a trace splits the device's
time between the two by the spans' windows.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

__all__ = ["ServeConfig", "Engine"]


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
        if self.cfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        z = logits.float().cpu().numpy() / self.cfg.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([rng.choice(p.shape[-1], p=row) for row in p])

    def _tokens(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    @torch.no_grad()
    def generate_batch(self, prompts: np.ndarray, max_new: int,
                       eos_id: int | None = None,
                       seed: int = 0) -> np.ndarray:
        """One batch of same-length prompts -> (B, <=max_new) generations."""
        if max_new < 1:
            raise ValueError(f"max_new must be at least 1, got {max_new}")
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        with record_function("serve.prefill"):
            logits, cache = self.model.prefill(
                self.params, {"tokens": self._tokens(prompts)},
                self.cfg.max_len)
            outs = [self._sample(logits, rng)]
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefills"] += 1
        alive = np.ones(prompts.shape[0], bool)
        while len(outs) < max_new:
            if eos_id is not None:
                alive &= outs[-1] != eos_id
                if not alive.any():
                    break
            t0 = time.perf_counter()
            with record_function("serve.decode_step"):
                logits, cache = self.model.decode_step(
                    self.params, {"tokens": self._tokens(outs[-1][:, None])},
                    cache)
                outs.append(self._sample(logits, rng))
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
        return np.stack(outs, axis=1)

    def serve(self, requests: list[np.ndarray], max_new: int,
              seed: int = 0) -> list[np.ndarray]:
        """Serve a request queue in slot-sized waves of equal-length
        prompts."""
        results: dict[int, np.ndarray] = {}
        queue = list(enumerate(requests))
        while queue:
            wave = queue[: self.cfg.slots]
            queue = queue[self.cfg.slots:]
            prompts = np.stack([p for _, p in wave])
            gen = self.generate_batch(prompts, max_new, seed=seed)
            for j, (i, _) in enumerate(wave):
                results[i] = gen[j]
        return [results[i] for i in range(len(requests))]
