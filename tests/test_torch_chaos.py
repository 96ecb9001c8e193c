"""The chaos runner of the port against the reference package's.

``TestChaosRunner`` is the reference's class of ``tests/test_runner_protocol.py``
re-pointed at ``repro_torch``: transparent when idle, deterministic when
faulting.  Beside it, the same seeded schedules over the same calls give
the same faults and the same perturbed samples in both packages, and the
port's counters stay exact when item threads share one runner.
"""
import sys
import threading

import numpy as np
import pytest

from repro.core import make_h100_like as ref_h100
from repro.core.errors import TransientRunnerError as RefTransientError
from repro.core.probes import ChaosRunner as RefChaosRunner
from repro.core.probes import FaultSchedule as RefFaultSchedule
from repro.core.probes import SimRunner as RefSimRunner
from repro_torch.core import make_h100_like
from repro_torch.core.errors import TransientRunnerError
from repro_torch.core.probes import ChaosRunner, FaultSchedule, SimRunner

KIB = 1024


class TestChaosRunner:
    """Chaos-specific halves of the contract: transparent when idle,
    deterministic when faulting (the property every fault-tolerance test
    and the ``fault_recovery`` bench gate lean on)."""

    def _base(self):
        return SimRunner(make_h100_like(seed=3))

    def test_zero_fault_schedule_is_bit_transparent(self):
        """No schedule -> every sample identical to the wrapped runner."""
        chaos, base = ChaosRunner(self._base()), self._base()
        info = base.spaces()[0]
        ab = min(info.max_bytes // 8, 64 * KIB)
        assert np.array_equal(chaos.pchase(info.name, ab, 32, 9),
                              base.pchase(info.name, ab, 32, 9))
        assert np.array_equal(
            np.asarray(chaos.pchase_batch(info.name, [ab, 2 * ab], 32, 9)),
            np.asarray(base.pchase_batch(info.name, [ab, 2 * ab], 32, 9)))
        assert chaos.faults_injected == 0

    def test_fault_replay_is_deterministic(self):
        """Two fresh runners over the same schedule fault on exactly the
        same calls — chaos runs are reproducible by construction."""
        sched = FaultSchedule(seed=42, transient_rate=0.3,
                              max_faults_per_request=2)

        def trace():
            chaos = ChaosRunner(self._base(), sched)
            info = chaos.spaces()[0]
            ab = min(info.max_bytes // 8, 64 * KIB)
            events = []
            for size in (ab, 2 * ab, 3 * ab):
                for _ in range(4):             # retries consume the budget
                    try:
                        chaos.pchase(info.name, size, 32, 9)
                        events.append(("ok", size))
                    except TransientRunnerError:
                        events.append(("fault", size))
            return events, chaos.faults_injected

        assert trace() == trace()

    def test_fault_budget_lets_retries_succeed(self):
        """Per-request fault budget: after ``max_faults_per_request``
        raises, the same request must succeed — retry loops terminate."""
        sched = FaultSchedule(seed=0, transient_rate=1.0,
                              max_faults_per_request=2)
        chaos = ChaosRunner(self._base(), sched)
        info = chaos.spaces()[0]
        ab = min(info.max_bytes // 8, 64 * KIB)
        for _ in range(2):
            with pytest.raises(TransientRunnerError):
                chaos.pchase(info.name, ab, 32, 9)
        out = np.asarray(chaos.pchase(info.name, ab, 32, 9))
        assert out.shape == (9,)
        assert chaos.faults_injected == 2

    def test_jitter_preserves_batch_equals_loop(self):
        """Perturbations are keyed by the per-row request signature, so a
        fused row and its single-call twin see the same noise — the
        batch==loop equivalence the engine's caching depends on."""
        sched = FaultSchedule(seed=9, jitter=0.05, outlier_rate=0.05)
        chaos = ChaosRunner(self._base(), sched)
        info = chaos.spaces()[0]
        ab = min(info.max_bytes // 8, 64 * KIB)
        sizes = [ab, 2 * ab, 3 * ab]
        batch = np.asarray(chaos.pchase_batch(info.name, sizes, 32, 9))
        for i, size in enumerate(sizes):
            assert np.array_equal(batch[i],
                                  np.asarray(chaos.pchase(info.name, size,
                                                          32, 9)))
        # ...and the jitter is actually doing something vs the base
        base = self._base()
        assert not np.array_equal(batch[0],
                                  np.asarray(base.pchase(info.name, ab, 32,
                                                         9)))

    def test_permanent_kind_always_faults(self):
        sched = FaultSchedule(seed=3, permanent_kinds=("bandwidth",))
        chaos = ChaosRunner(self._base(), sched)
        for _ in range(4):
            with pytest.raises(TransientRunnerError):
                chaos.bandwidth("L2", "read")
        # other kinds stay clean
        info = chaos.spaces()[0]
        ab = min(info.max_bytes // 8, 64 * KIB)
        assert np.asarray(chaos.pchase(info.name, ab, 32, 9)).shape == (9,)

    def test_kill_after_terminates_run(self):
        sched = FaultSchedule(seed=3, kill_after=2)
        chaos = ChaosRunner(self._base(), sched)
        info = chaos.spaces()[0]
        ab = min(info.max_bytes // 8, 64 * KIB)
        chaos.pchase(info.name, ab, 32, 9)
        chaos.pchase(info.name, 2 * ab, 32, 9)
        with pytest.raises(RuntimeError, match="chaos kill"):
            chaos.pchase(info.name, 3 * ab, 32, 9)


# --------------------------------------------------------------------------
# The port against the reference: one schedule, one call sequence
# --------------------------------------------------------------------------
SCHEDULES = {
    "transient": dict(seed=42, transient_rate=0.3, max_faults_per_request=2),
    "batch": dict(seed=4, transient_rate=0.2, batch_fault_rate=0.5),
    "permanent": dict(seed=3, permanent_kinds=("sharing", "bandwidth")),
    "perturb": dict(seed=9, jitter=0.05, outlier_rate=0.05,
                    throttle_after=4, throttle_slope=0.01),
    "kill": dict(seed=1, kill_after=9),
}


def _calls():
    """A fixed sequence of every gated capability, each asked 3 times so
    the per-request fault budgets are spent and met again."""
    sizes = [16 * KIB, 32 * KIB, 48 * KIB]
    ev = [("amount", "L1", 0, 1, 64 * KIB),
          ("sharing", "L1", "Texture", 32 * KIB)]
    many = [("L1", 16 * KIB, 32), ("L2", 1024 * KIB, 64)]
    once = [
        lambda r: r.pchase("L1", 64 * KIB, 32, 9),
        lambda r: r.pchase_batch("L1", sizes, 32, 9),
        lambda r: r.cold_chase("L2", 512 * KIB, 64, 9),
        lambda r: r.cold_chase_batch("L1", [64 * KIB] * 3, [8, 16, 32], 9),
        lambda r: r.pchase_many(many, 9),
        lambda r: r.cold_chase_many(many, 9),
        lambda r: r.amount_probe("L1", 0, 1, 64 * KIB, 9),
        lambda r: r.sharing_probe("L1", "Texture", 32 * KIB, 9),
        lambda r: r.eviction_many(ev, 9),
        lambda r: r.bandwidth("L2", "read"),
    ]
    return once * 3


def _trace(runner) -> list:
    events = []
    for call in _calls():
        try:
            events.append(("ok", np.asarray(call(runner)).tolist()))
        except (TransientRunnerError, RefTransientError, RuntimeError) as e:
            events.append((type(e).__name__, str(e)))
    counts = (runner.calls, runner.faults_injected, runner.batch_faults,
              dict(runner.base_calls))
    return events, counts


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_replay_equals_reference(name):
    """Faults, messages, counters and every sample value, bit for bit
    (the reference raises its own ``TransientRunnerError``: compared by
    name and message)."""
    got = _trace(ChaosRunner(SimRunner(make_h100_like(seed=3)),
                             FaultSchedule(**SCHEDULES[name])))
    want = _trace(RefChaosRunner(RefSimRunner(ref_h100(seed=3)),
                                 RefFaultSchedule(**SCHEDULES[name])))
    assert got == want
    assert any(kind != "ok" for kind, _ in got[0]) or name == "perturb"


class _Instant:
    """A base runner whose probe costs nothing, so the threads spend their
    time in the chaos runner's own bookkeeping."""

    def pchase(self, space, array_bytes, stride, n_samples):
        return [0.0] * n_samples


def test_counters_exact_under_threads():
    """Eight threads share one runner and ask the same 256 signatures at
    once, twice each, with the interpreter switching threads every
    microsecond: no count is lost, and each signature's fault budget (one)
    is spent exactly once."""
    chaos = ChaosRunner(_Instant(), FaultSchedule(seed=0, transient_rate=1.0,
                                                  max_faults_per_request=1))
    sigs = [16 * KIB + 4 * KIB * i for i in range(256)] * 2
    outcomes = []
    lock = threading.Lock()

    def work():
        for size in sigs:
            try:
                chaos.pchase("L1", size, 32, 5)
                ok = True
            except TransientRunnerError:
                ok = False
            with lock:
                outcomes.append(ok)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert chaos.calls == len(outcomes) == 8 * len(sigs)
    assert chaos.base_calls == {"pchase": 8 * len(sigs)}
    assert chaos.faults_injected == outcomes.count(False) == len(sigs) // 2
