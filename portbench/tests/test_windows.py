"""The windows' accounting on a stand-in engine and a stand-in clock:
open-loop times to first token and the drain, closed-loop partial waves
and the close at a step's end."""
import numpy as np
import pytest

from harness import serving
from harness.trace import Tracer


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class FakeEngine:
    """``generate_batch``: a prefill of ``prefill_s`` a prompt position
    (whole wave), then ``step_s`` a decode step; ids reach the host through
    ``_sample`` as the port's engine does."""

    def __init__(self, clock, prefill_s=1e-3, step_s=0.01):
        self.clock, self.prefill_s, self.step_s = clock, prefill_s, step_s
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "prefills": 0,
                      "decode_steps": 0}
        self.calls = []

    def _sample(self, logits, rng):
        return np.zeros(logits.shape[0], np.int64)

    def generate_batch(self, prompts, max_new, eos_id=None, seed=0):
        b, t = prompts.shape
        self.calls.append((b, t))
        logits = np.zeros((b, 7))
        self.clock.t += self.prefill_s * t
        outs = [self._sample(logits, None)]
        self.stats["prefill_s"] += self.prefill_s * t
        self.stats["prefills"] += 1
        while len(outs) < max_new:
            self.clock.t += self.step_s
            outs.append(self._sample(logits, None))
            self.stats["decode_s"] += self.step_s
            self.stats["decode_steps"] += 1
        return np.stack(outs, axis=1)


def _open(rate, seconds=2.0, prefill_s=1e-3):
    clock = Clock()
    eng = FakeEngine(clock, prefill_s)
    sampler = serving.Sampler(eng, Tracer(False), clock)
    t = {"loop": "open", "arrival": "even", "rate_per_s": rate,
         "prompt_lengths": [64, 128], "new_tokens": 4, "slots": 3}
    res = serving.run_open(eng, sampler, t, 5, seconds, 50, clock=clock,
                           sleep=clock.sleep)
    return res, eng


def test_open_loop_light_load():
    res, eng = _open(rate=2.0)
    # 4 requests, each served alone as it comes: 64 or 128 prompt positions
    assert res.attempted == 4 and len(res.ttft) == 4 and res.failed == 0
    assert sorted(res.ttft.values()) == pytest.approx(
        sorted([0.064, 0.128] * 2))
    assert len(res.finished) == 4 and res.tokens == 16


def test_open_loop_drains_and_counts_from_due():
    # 10 requests a second for 2 s; a 128-position prefill takes 1.28 s, so
    # a queue builds and is drained after the window
    res, eng = _open(rate=10.0, prefill_s=1e-2)
    assert res.attempted == 20 and len(res.ttft) == 20
    assert res.window_s > 2.0                     # drained past the window
    assert all(b <= 3 for b, _ in eng.calls)
    assert sum(b for b, _ in eng.calls) == 20
    # the last request due waits for every wave before it
    last = max(res.ttft, key=lambda i: i)
    assert res.ttft[last] > 1.0


def _closed(seconds):
    clock = Clock()
    eng = FakeEngine(clock, prefill_s=1e-3, step_s=0.1)
    sampler = serving.Sampler(eng, Tracer(False), clock)
    t = {"loop": "closed", "wave_size": 4, "prompt_lengths": [100],
         "new_tokens": 10}
    return serving.run_closed(eng, sampler, t, 5, seconds, 50,
                              clock=clock), eng


def test_closed_loop_counts_partial_wave_and_closes_at_step_end():
    res, eng = _closed(1.55)
    # a wave: prefill 0.1 s, 9 steps 0.9 s -> 1.0 s; the second wave's
    # prefill ends at 1.1 s and its steps at 1.2, ..., 1.6 s: the step
    # running at 1.55 s ends at 1.6 s and closes the window; a wave has
    # finished, so the second one stops there, and no third starts
    assert res.window_s == pytest.approx(1.6)
    assert res.run_s == pytest.approx(1.6)
    assert res.tokens == 4 * 10 + 4 * (1 + 5)
    assert len(res.finished) == 4 and res.attempted == 8 and res.waves == 1
    assert res.failed == 0
    assert res.stats["decode_steps"] == 9 + 4     # the closing step's not
    assert len(eng.calls) == 2


def test_closed_loop_first_wave_runs_to_its_end():
    # the window closes inside the first wave (the step ending at 0.6 s):
    # no wave has finished, so that one runs on to 1.0 s and is checked
    res, eng = _closed(0.55)
    assert res.window_s == pytest.approx(0.6)
    assert res.run_s == pytest.approx(1.0)
    assert res.tokens == 4 * (1 + 5)
    assert len(res.finished) == 4 and res.attempted == 4 and res.waves == 1
    assert len(eng.calls) == 1


@pytest.mark.parametrize("seed", range(8))
def test_check_sample_draws_the_longest_among_equals_from_the_seed(seed):
    from harness.checks import sample_requests
    finished = {i: (np.zeros(8), np.zeros(4)) for i in range(16)}
    finished[3] = (np.zeros(8), np.zeros(2))
    picked = sample_requests(finished, 2**31 + seed, 4)
    assert len(picked) == len(set(picked)) == 4 and 3 not in picked[:1]
    firsts = {sample_requests(finished, 2**31 + k, 4)[0] for k in range(8)}
    assert len(firsts) > 1                  # not always the lowest index
