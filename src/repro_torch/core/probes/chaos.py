"""Chaos-injected probe runner: deterministic fault schedules over any backend.

The paper's claim is *reliable* discovery on noisy hardware; the resilience
machinery that backs it (engine retry, fused-round splitting, graceful
degradation, checkpoint/resume) needs faults on demand to be testable
without a flaky GPU.  ``ChaosRunner`` wraps any ``ProbeRunner`` and injects
a seeded, replayable fault schedule:

* **transient raises** — ``TransientRunnerError`` on single probes, with a
  per-request fault budget so a retried request eventually succeeds;
* **batch faults** — the same, on ``pchase_many``/``cold_chase_many``/
  ``eviction_many``/``*_batch`` fused dispatches, exercising the fusion
  dispatcher's split-and-retry path;
* **permanent faults** — call kinds listed in ``permanent_kinds`` raise on
  *every* attempt, driving an attribute past the retry budget into the
  ``provenance="degraded"`` path;
* **value perturbations** — per-sample multiplicative jitter, outlier
  spikes, and a sustained throttle ramp, feeding the MAD gating and
  adaptive-resampling hardening;
* **a kill switch** — ``kill_after=N`` raises a non-transient error once
  ``N`` probes have run, simulating a mid-discovery crash for the
  checkpoint/resume path.

Every decision is a pure function of ``(schedule.seed, call signature,
per-signature attempt index)`` — never of wall time or global RNG state —
so two runners with the same schedule replay the same faults on the same
call sequence, and perturbations are keyed per row signature so
batch == loop equivalence survives jitter.  A default (zero-fault)
schedule is a bit-exact passthrough.

The counters are updated under a lock, so concurrent callers (the
scheduler's item threads) never lose a count.  Which call is the N-th one
is still theirs to race for: under threads, *which* items finish before
``kill_after`` fires, and which signature attempt meets a fault first,
follow the thread order; run the scheduler inline (``max_workers=0``) for
a replay that is the same every time.
"""
from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass

import numpy as np

from ..errors import TransientRunnerError

__all__ = ["ChaosRunner", "FaultSchedule", "build_chaos_runner"]


def build_chaos_runner(base_spec, schedule) -> "ChaosRunner":
    """Rebuild a ``ChaosRunner`` over its base's spec (pool-worker side)."""
    return ChaosRunner(base_spec.build(), schedule)


@dataclass(frozen=True)
class FaultSchedule:
    """A seeded, replayable description of what goes wrong and when.

    All rates are probabilities in ``[0, 1]`` evaluated per call (or per
    sample for ``outlier_rate``) from a hash of the call signature — not
    from mutable RNG state — so replay is exact.  The default instance
    injects nothing and perturbs nothing.
    """

    seed: int = 0
    #: probability a single probe call raises ``TransientRunnerError``
    transient_rate: float = 0.0
    #: per-request-signature cap on injected transient faults (a retried
    #: request passes once its budget is spent)
    max_faults_per_request: int = 1
    #: probability a fused batch dispatch raises ``TransientRunnerError``
    batch_fault_rate: float = 0.0
    #: lognormal per-sample timing noise (sigma of ``exp(jitter * N(0,1))``)
    jitter: float = 0.0
    #: probability an individual sample is an outlier spike
    outlier_rate: float = 0.0
    #: multiplier applied to outlier samples
    outlier_scale: float = 8.0
    #: probe-call count after which a throttle ramp starts (None = never)
    throttle_after: int | None = None
    #: fractional slowdown added per call past ``throttle_after``
    throttle_slope: float = 0.0
    #: call kinds ("pchase", "cold", "amount", "sharing", "cu",
    #: "bandwidth") that fault on EVERY attempt — the degradation driver
    permanent_kinds: tuple = ()
    #: global probe-call count after which every call raises a
    #: non-transient ``RuntimeError`` — the mid-discovery kill switch
    kill_after: int | None = None
    #: probe-call count after which the runner hard-exits the *process* —
    #: but only inside a parallel-pool worker (``MT4G_POOL_WORKER`` env),
    #: simulating a crashed worker mid-shard.  The coordinator-side twin
    #: of the same schedule ignores it, so the pool's crash containment
    #: (respawn + ``TransientRunnerError`` + resilience retry) is what
    #: gets exercised, and the retry — served by a fresh worker whose
    #: call count restarts — converges.
    kill_worker_after: int | None = None

    @property
    def value_preserving(self) -> bool:
        """True when the schedule never alters sample values (it may still
        raise) — the condition under which a wrapped deterministic runner
        stays deterministic."""
        return (self.jitter == 0.0 and self.outlier_rate == 0.0
                and self.throttle_after is None)


class ChaosRunner:
    """``ProbeRunner`` wrapper injecting a ``FaultSchedule`` over any base.

    Implements the full protocol surface (including the fused
    ``pchase_many``/``eviction_many`` capabilities and the SimRunner
    extras ``cu_sharing_probe``/``api_size``/``cu_ids``) by gating each
    call through the schedule and delegating to the base runner.
    Counters (``calls``, ``faults_injected``, ``batch_faults``,
    ``base_calls``) make fault/recovery behavior assertable in tests and
    on the card.
    """

    def __init__(self, base, schedule: FaultSchedule | None = None):
        self.base = base
        self.schedule = schedule or FaultSchedule()
        self.calls = 0
        self.faults_injected = 0
        self.batch_faults = 0
        self.base_calls: dict[str, int] = {}
        self._attempts: dict[str, int] = {}
        self._faulted: dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def deterministic(self) -> bool:
        """Bit-identical replay: requires a deterministic base AND a
        value-preserving schedule (faults may raise, never skew)."""
        return (bool(getattr(self.base, "deterministic", False))
                and self.schedule.value_preserving)

    # ------------------------------------------------------------ schedule
    def _uniform(self, *parts) -> float:
        """Deterministic uniform draw in [0, 1) keyed by the call parts."""
        blob = repr((self.schedule.seed,) + parts).encode()
        h = hashlib.blake2b(blob, digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def _rng(self, *parts) -> np.random.Generator:
        blob = repr((self.schedule.seed,) + parts).encode()
        h = hashlib.blake2b(blob, digest_size=8).digest()
        return np.random.default_rng(int.from_bytes(h, "big"))

    def _count(self, kind: str) -> None:
        with self._lock:
            self.calls += 1
            calls = self.calls
            self.base_calls[kind] = self.base_calls.get(kind, 0) + 1
        sch = self.schedule
        if sch.kill_after is not None and calls > sch.kill_after:
            raise RuntimeError(
                f"chaos kill: probe call {calls} is past the "
                f"kill_after={sch.kill_after} horizon")
        if (sch.kill_worker_after is not None
                and os.environ.get("MT4G_POOL_WORKER")
                and calls > sch.kill_worker_after):
            # Hard process death, not an exception: the pool must detect
            # the broken pipe, respawn, and surface a transient fault.
            os._exit(17)

    def _budgeted_fault(self, sig: tuple, salt: str, rate: float,
                        batch: bool = False) -> int | None:
        """Count one attempt of ``sig``; its attempt number when the
        schedule faults it (within the per-request budget), else None."""
        key = repr(sig)
        with self._lock:
            attempt = self._attempts[key] = self._attempts.get(key, 0) + 1
            if not (self._faulted.get(key, 0)
                    < self.schedule.max_faults_per_request
                    and self._uniform(salt, sig, attempt - 1) < rate):
                return None
            self._faulted[key] = self._faulted.get(key, 0) + 1
            self.batch_faults += batch
            self.faults_injected += 1
        return attempt

    def _gate(self, kind: str, sig: tuple) -> None:
        """Count one single-probe call; raise per the schedule."""
        self._count(kind)
        sch = self.schedule
        if kind in sch.permanent_kinds:
            with self._lock:
                self.faults_injected += 1
            raise TransientRunnerError(f"chaos permanent fault: {kind} {sig}")
        attempt = self._budgeted_fault(sig, "fault", sch.transient_rate)
        if attempt is not None:
            raise TransientRunnerError(
                f"chaos transient fault: {sig} (attempt {attempt})")

    def _gate_batch(self, kind: str, sig: tuple, row_kinds=()) -> None:
        """Count one fused dispatch; raise per the batch schedule."""
        self._count(kind)
        sch = self.schedule
        # Permanent faults fire on the batch capability itself OR on any
        # row kind it carries (a fused grid with one doomed family fails
        # as a whole — the dispatcher's split path sorts out the rows).
        for rk in (kind, *row_kinds):
            if rk in sch.permanent_kinds:
                with self._lock:
                    self.batch_faults += 1
                    self.faults_injected += 1
                raise TransientRunnerError(
                    f"chaos permanent fault in fused batch: {rk}")
        attempt = self._budgeted_fault(sig, "batch-fault",
                                       sch.batch_fault_rate, batch=True)
        if attempt is not None:
            raise TransientRunnerError(
                f"chaos batch fault: {kind} (attempt {attempt})")

    def _perturb(self, arr, sig: tuple):
        """Apply jitter/outliers/throttle to one row, keyed by its request
        signature so identical requests (and fused rows vs. single calls)
        perturb identically."""
        sch = self.schedule
        throttled = (sch.throttle_after is not None
                     and self.calls > sch.throttle_after)
        if sch.jitter == 0.0 and sch.outlier_rate == 0.0 and not throttled:
            return arr
        out = np.asarray(arr, dtype=float).copy()
        rng = self._rng("perturb", sig)
        if sch.jitter:
            out *= np.exp(sch.jitter * rng.standard_normal(out.shape))
        if sch.outlier_rate:
            mask = rng.random(out.shape) < sch.outlier_rate
            out[mask] *= sch.outlier_scale
        if throttled:
            out *= 1.0 + sch.throttle_slope * (self.calls - sch.throttle_after)
        return out

    # ------------------------------------------------------------ protocol
    def spaces(self):
        """Structural query — never gated, never perturbed."""
        return self.base.spaces()

    def pchase(self, space, array_bytes, stride, n_samples):
        """Warm p-chase with chaos gating + per-row perturbation."""
        sig = ("pchase", space, int(array_bytes), int(stride), int(n_samples))
        self._gate("pchase", sig)
        out = self.base.pchase(space, array_bytes, stride, n_samples)
        return self._perturb(out, sig)

    def pchase_batch(self, space, array_bytes_list, stride, n_samples):
        """Size-sweep batch; faults via the batch schedule, rows perturbed
        under their single-call signatures (batch == loop holds)."""
        sig = ("pchase_batch", space, tuple(int(a) for a in array_bytes_list),
               int(stride), int(n_samples))
        self._gate_batch("pchase_batch", sig)
        out = np.asarray(self.base.pchase_batch(space, array_bytes_list,
                                                stride, n_samples))
        rows = [self._perturb(out[i], ("pchase", space, int(ab), int(stride),
                                       int(n_samples)))
                for i, ab in enumerate(array_bytes_list)]
        return np.stack(rows)

    def cold_chase(self, space, array_bytes, stride, n_samples):
        """Cold-pass chase with chaos gating + perturbation."""
        sig = ("cold", space, int(array_bytes), int(stride), int(n_samples))
        self._gate("cold", sig)
        out = self.base.cold_chase(space, array_bytes, stride, n_samples)
        return self._perturb(out, sig)

    def cold_chase_batch(self, space, array_bytes_list, stride_list,
                         n_samples):
        """Granularity stride-sweep batch under the batch schedule."""
        sig = ("cold_batch", space, tuple(int(a) for a in array_bytes_list),
               tuple(int(s) for s in stride_list), int(n_samples))
        self._gate_batch("cold_batch", sig)
        out = self.base.cold_chase_batch(space, array_bytes_list, stride_list,
                                         n_samples)
        rows = [self._perturb(np.asarray(out[i]),
                              ("cold", space, int(ab), int(st),
                               int(n_samples)))
                for i, (ab, st) in enumerate(zip(array_bytes_list,
                                                 stride_list))]
        return rows if isinstance(out, list) else np.stack(rows)

    def pchase_many(self, requests, n_samples):
        """Cross-family fused batch — the fusion dispatcher's main target."""
        reqs = [(sp, int(ab), int(st)) for sp, ab, st in requests]
        sig = ("pchase_many", tuple(reqs), int(n_samples))
        self._gate_batch("pchase_many", sig)
        out = np.asarray(self.base.pchase_many(reqs, n_samples))
        rows = [self._perturb(out[i], ("pchase", sp, ab, st, int(n_samples)))
                for i, (sp, ab, st) in enumerate(reqs)]
        return np.stack(rows)

    def cold_chase_many(self, requests, n_samples):
        """Fused heterogeneous cold-pass batch."""
        reqs = [(sp, int(ab), int(st)) for sp, ab, st in requests]
        sig = ("cold_many", tuple(reqs), int(n_samples))
        self._gate_batch("cold_many", sig)
        out = self.base.cold_chase_many(reqs, n_samples)
        rows = [self._perturb(np.asarray(out[i]),
                              ("cold", sp, ab, st, int(n_samples)))
                for i, (sp, ab, st) in enumerate(reqs)]
        return rows if isinstance(out, list) else np.stack(rows)

    def amount_probe(self, space, core_a, core_b, array_bytes, n_samples):
        """§IV-F amount probe with chaos gating."""
        sig = ("amount", space, int(core_a), int(core_b), int(array_bytes),
               int(n_samples))
        self._gate("amount", sig)
        out = self.base.amount_probe(space, core_a, core_b, array_bytes,
                                     n_samples)
        return self._perturb(out, sig)

    def sharing_probe(self, space_a, space_b, array_bytes, n_samples):
        """§IV-G sharing probe with chaos gating."""
        sig = ("sharing", space_a, space_b, int(array_bytes), int(n_samples))
        self._gate("sharing", sig)
        out = self.base.sharing_probe(space_a, space_b, array_bytes,
                                      n_samples)
        return self._perturb(out, sig)

    def cu_sharing_probe(self, cu_a, cu_b, array_bytes, n_samples,
                         space="sL1d"):
        """§IV-H CU sharing probe (delegates; raises if the base lacks it)."""
        sig = ("cu", space, int(cu_a), int(cu_b), int(array_bytes),
               int(n_samples))
        self._gate("cu", sig)
        out = self.base.cu_sharing_probe(cu_a, cu_b, array_bytes, n_samples,
                                         space=space)
        return self._perturb(out, sig)

    def cu_sharing_probe_batch(self, cu_a, cu_bs, array_bytes, n_samples,
                               space="sL1d"):
        """Batched CU sharing probe under the batch schedule."""
        sig = ("cu_batch", space, int(cu_a), tuple(int(b) for b in cu_bs),
               int(array_bytes), int(n_samples))
        self._gate_batch("cu_batch", sig, row_kinds=("cu",))
        out = np.asarray(self.base.cu_sharing_probe_batch(
            cu_a, cu_bs, array_bytes, n_samples, space=space))
        rows = [self._perturb(out[i], ("cu", space, int(cu_a), int(b),
                                       int(array_bytes), int(n_samples)))
                for i, b in enumerate(cu_bs)]
        return np.stack(rows)

    def eviction_many(self, requests, n_samples):
        """Mixed amount/sharing/cu eviction grid under the batch schedule.

        A permanent-kind row faults the whole dispatch (transiently), which
        is exactly what drives the dispatcher's split-into-singles path —
        where the offending row keeps faulting and the rest succeed.
        """
        reqs = [tuple(v if isinstance(v, str) else int(v) for v in r)
                for r in requests]
        sig = ("eviction_many", tuple(reqs), int(n_samples))
        self._gate_batch("eviction_many", sig,
                         row_kinds=tuple({r[0] for r in reqs}))
        out = np.asarray(self.base.eviction_many(reqs, n_samples))
        rows = []
        for i, r in enumerate(reqs):
            row_sig = tuple(r) + (int(n_samples),)
            rows.append(self._perturb(out[i], row_sig))
        return np.stack(rows)

    def bandwidth(self, space, mode="read"):
        """Streaming bandwidth with chaos gating (scalar perturbation)."""
        sig = ("bandwidth", space, mode)
        self._gate("bandwidth", sig)
        out = float(self.base.bandwidth(space, mode))
        return float(np.asarray(self._perturb(np.asarray([out]), sig))[0])

    # ----------------------------------------------------- optional extras
    def api_size(self, space):
        """API-reported capacity, when the base exposes it (else None)."""
        fn = getattr(self.base, "api_size", None)
        return fn(space) if fn is not None else None

    def cu_ids(self):
        """CU ids participating in sharing groups ([] for single-actor
        bases, which keeps the engine from scheduling cu probes)."""
        fn = getattr(self.base, "cu_ids", None)
        return fn() if fn is not None else []

    @property
    def cores_per_sm(self):
        """Delegated; AttributeError propagates when the base lacks it, so
        ``hasattr`` checks see the base's true capability."""
        return self.base.cores_per_sm

    def runner_spec(self):
        """Rebuild recipe for pool workers: the base's spec wrapped with
        this schedule (``FaultSchedule`` is frozen and picklable), or None
        when the base publishes none.  Fault *gating* counters are
        per-process, so worker-side fault timing differs from inline —
        sample values never do (perturbations are signature-keyed)."""
        fn = getattr(self.base, "runner_spec", None)
        base_spec = fn() if fn is not None else None
        if base_spec is None:
            return None
        from ..engine.parallel import RunnerSpec

        return RunnerSpec(build_chaos_runner, (base_spec, self.schedule))
