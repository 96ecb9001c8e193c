"""Serving windows over the port's ``Engine``.

The port has no scheduler of arrivals: ``Engine.generate_batch`` serves one
wave of equal-length prompts (a prefill, then a decode step a token for
the whole wave).  The wave former here is the benchmark's own, frozen with
it: the oldest waiting request picks the prompt length, and the wave takes
up to ``slots`` waiting requests of that length in the order they came.

* Open loop (``run_open``): every request due in the window is served; the
  requests still waiting when the window ends are drained, and their first
  tokens count.  A request's time to first token runs from when it was
  due to when its wave's first sampled ids reach the host.
* Closed loop (``run_closed``): equal waves back to back from a wave
  boundary.  The window closes at the end of the decode step (or prefill)
  running when ``seconds`` have passed, and counts every id that reached
  the host inside it, those of an unfinished wave too.  Where a wave has
  finished by then, the running one stops there (its requests are
  attempted, neither finished nor failed) and the check reads the finished
  waves; otherwise the first wave runs to its end outside the window, so
  that some requests finish.  No other wave starts.

Both see the engine's sampling (``Engine._sample``, wrapped on the
instance): when ids reach the host, and, in a traced run, a marker after
each prefill and decode step.  ``fault`` plants a fault underneath the
timed path, for the tests that show the check catches it: a ``"token"``
fault alters the first decoded id of the wave's last slot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .traffic import closed_wave, open_schedule, prompt_ids

__all__ = ["ServeResult", "Sampler", "WindowClosed", "run_open",
           "run_closed", "warm_up", "UnchangedStepModel"]


@dataclass
class ServeResult:
    ttft: dict = field(default_factory=dict)          # index -> seconds
    finished: dict = field(default_factory=dict)      # index -> (prompt, ids)
    attempted: int = 0
    failed: int = 0
    tokens: int = 0                                   # ids in the window
    window_s: float = 0.0
    run_s: float = 0.0                                # with the drain
    waves: int = 0                                    # finished
    stats: dict = field(default_factory=dict)         # engine's, window


class WindowClosed(Exception):
    """Raised by ``Sampler`` at a closed loop's close, once ``cut`` is set,
    to stop the running wave."""


class Sampler:
    """Wraps an engine's sampling: times each sampled batch, marks it for
    the tracer, closes a closed loop's window (and the tracer's session
    with it), stops the running wave there once ``cut`` is set, and plants
    a ``"token"`` fault (one id altered where it is produced)."""

    def __init__(self, engine, tracer, clock, fault=None):
        self.engine, self.tracer, self.clock = engine, tracer, clock
        self.fault = fault
        self.inner = engine._sample
        self.deadline = None
        self.wave = None                  # (batch, prompt length)
        self.k = 0                        # samples so far in this wave
        self.first = None                 # host time of the wave's first ids
        self.tokens = 0
        self.t0 = None
        self.close = None                 # (host time, ids, engine stats)
        self.cut = False                  # stop the running wave at close
        self.log = None             # a list: (host time, ids, wave, k)
        engine._sample = self

    def start_wave(self, batch: int, length: int) -> None:
        self.wave, self.k, self.first = (batch, length), 0, None

    def __call__(self, logits, rng):
        out = self.inner(logits, rng)
        b, t = self.wave
        if self.fault == "token" and self.k == 1:
            out = out.copy()
            out[-1] = (out[-1] + 1) % logits.shape[-1]
        now = self.clock()
        if self.k == 0:
            self.first = now
            self.tracer.mark(f"prefill_{t}", kind="prefill", batch=b,
                             seq=t)
        else:
            self.tracer.mark("decode_step", kind="decode", batch=b,
                             valid=t + self.k)
        if self.log is not None:
            self.log.append((now, out.shape[0], self.wave, self.k))
        self.k += 1
        self.tokens += out.shape[0]
        if self.deadline is not None and self.close is None \
                and now >= self.deadline:
            self.close = (now, self.tokens, dict(self.engine.stats))
            self.tracer.stop(now - self.t0)
            if self.cut:
                raise WindowClosed
        return out


class UnchangedStepModel:
    """The port's model with a decode step that returns its state
    unchanged: the cache as it was and the logits of the step before, so
    the new id is never taken in (the fault of a step that returns its
    state unchanged)."""

    def __init__(self, model):
        self.model = model
        self.logits = None

    def prefill(self, *a, **kw):
        self.logits, cache = self.model.prefill(*a, **kw)
        return self.logits, cache

    def decode_step(self, params, batch, cache, *a, **kw):
        return self.logits, cache


def _stats(engine) -> dict:
    return dict(engine.stats)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def warm_up(engine, sampler, lengths, batch: int, vocab: int) -> None:
    """One wave of ``batch`` prompts of each length, two ids each: every
    prefill length and the decode step the window will run."""
    rng = np.random.default_rng(0)
    for t in lengths:
        prompts = rng.integers(0, vocab, (batch, t), dtype=np.int64)
        sampler.start_wave(batch, t)
        engine.generate_batch(prompts, 2)


def run_open(engine, sampler, traffic: dict, seed: int, seconds: float,
             vocab: int, clock=time.perf_counter,
             sleep=time.sleep) -> ServeResult:
    """Serve every request due in ``seconds`` (and drain them)."""
    reqs = open_schedule(traffic, seed, seconds)
    prompts = {r.index: prompt_ids(seed, r.index, r.length, vocab)
               for r in reqs}
    slots, new = int(traffic["slots"]), int(traffic["new_tokens"])
    res = ServeResult(attempted=len(reqs))
    before = _stats(engine)
    waiting, nxt = [], 0
    t0 = clock()
    while nxt < len(reqs) or waiting:
        now = clock() - t0
        while nxt < len(reqs) and reqs[nxt].due <= now:
            waiting.append(reqs[nxt])
            nxt += 1
        if not waiting:
            sampler.tracer.mark("waiting for arrivals")
            sleep(max(reqs[nxt].due - now, 0.0))
            continue
        length = waiting[0].length
        wave = [r for r in waiting if r.length == length][:slots]
        taken = {r.index for r in wave}
        waiting = [r for r in waiting if r.index not in taken]
        sampler.start_wave(len(wave), length)
        gen = engine.generate_batch(np.stack([prompts[r.index]
                                              for r in wave]), new)
        res.waves += 1
        for j, r in enumerate(wave):
            res.ttft[r.index] = sampler.first - t0 - r.due
            if gen.shape[1:] == (new,):
                res.finished[r.index] = (prompts[r.index], gen[j])
            else:
                res.failed += 1
            res.tokens += gen.shape[1]
    res.window_s = res.run_s = clock() - t0
    res.stats = _delta(_stats(engine), before)
    return res


def run_closed(engine, sampler, traffic: dict, seed: int, seconds: float,
               vocab: int, clock=time.perf_counter) -> ServeResult:
    """Equal waves back to back until the step running at ``seconds``
    ends; that wave stops there where one has finished before it, and
    otherwise runs to its end."""
    new = int(traffic["new_tokens"])
    res = ServeResult()
    before = _stats(engine)
    wave = 0
    idx, prompts = closed_wave(traffic, seed, wave, vocab)
    sampler.tokens, sampler.close, sampler.cut = 0, None, False
    t0 = sampler.t0 = clock()
    sampler.deadline = t0 + seconds
    try:
        while sampler.close is None:
            if wave:
                idx, prompts = closed_wave(traffic, seed, wave, vocab)
            res.attempted += len(idx)
            sampler.start_wave(*prompts.shape)
            try:
                gen = engine.generate_batch(prompts, new)
            except WindowClosed:
                break
            res.waves += 1
            for j, i in enumerate(idx):
                if gen.shape[1:] == (new,):
                    res.finished[i] = (prompts[j], gen[j])
                else:
                    res.failed += 1
            wave += 1
            sampler.cut = True
    finally:
        sampler.deadline, sampler.cut = None, False
    res.run_s = clock() - t0
    close, res.tokens, stats = sampler.close
    res.window_s = close - t0
    res.stats = _delta(stats, before)
    return res
