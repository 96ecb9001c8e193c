"""The reference's job-engine cases (``tests/test_jobs.py``), re-pointed at
the port's ``serve/jobs.py``.

Covers the wire-format validation (``resolve_discovery``), the job state
machine, content-addressed idempotency (attach-while-in-flight, store-hit
after completion), capped retry with exponential backoff (sleeps recorded
via the injectable ``sleep``), fail-fast on non-transient errors, per-job
timeouts, cancellation, the bounded queue, history trimming, and the
metrics snapshot.  Everything runs in-process against simulated devices —
no HTTP (see ``test_torch_remote_discovery.py`` for the live-server paths).

The port's own backend, ``"cuda"``, takes the place of the reference's
``"pallas"``: its job key is the key ``discover_cuda`` persists under;
without a card its job fails naming CUDA and runs nothing on the CPU; and
two ``"cuda"`` jobs never run at once.  ``"host"`` takes the reference's
fields, keys as ``discover_host`` persists, and refuses a card's fields.
"""
import threading

import pytest

from repro_torch.core import discover_sim, make_h100_like
from repro_torch.core.engine.store import TopologyStore, request_key
from repro_torch.serve.jobs import (JOB_LATENCY_BUCKETS_S, JobEngine,
                                    QueueFullError, TransientRunnerError,
                                    resolve_discovery)

SIM_H100 = {"backend": "sim", "device": "h100", "seed": 71, "n_samples": 9}


@pytest.fixture
def store(tmp_path):
    return TopologyStore(str(tmp_path / "store"))


def make_engine(store, **kw):
    """Engine with fast, recorded backoff; caller must ``stop()`` (or never
    ``start()``)."""
    kw.setdefault("workers", 1)
    kw.setdefault("backoff_base_s", 0.01)
    return JobEngine(store, **kw)


class TestResolveDiscovery:
    def test_key_matches_store_key_after_run(self, store):
        descriptor, key, run = resolve_discovery(SIM_H100, store)
        assert key == request_key(descriptor)
        topo, timings = run()
        assert store.has(key)               # job key == store write key
        assert topo.model == "sim-h100"

    def test_device_alias_and_canonical_name_share_a_key(self, store):
        _, key_alias, _ = resolve_discovery(SIM_H100, store)
        _, key_full, _ = resolve_discovery({**SIM_H100, "device": "sim-h100"},
                                           store)
        assert key_alias == key_full

    @pytest.mark.parametrize("params, fragment", [
        ("not-a-dict", "JSON object"),
        ({"backend": "pallas"}, "unknown backend"),
        ({"backend": "host", "device": "h100"}, "unknown field"),
        ({"backend": "cuda", "device": "h100"}, "unknown field"),
        ({"backend": "sim", "device": "rtx5090"}, "unknown simulated device"),
        ({"backend": "sim", "device": "h100", "max_bytes": 1}, "unknown field"),
        ({"backend": "sim", "device": "h100", "n_samples": 0}, "n_samples"),
        ({"backend": "sim", "device": "h100", "elements": []}, "elements"),
        ({"backend": "sim", "device": "h100", "budget": {"max_probes": 5}},
         "unknown budget field"),
        ({"backend": "sim", "device": "h100", "gc_policy": {"ttl": 5}},
         "unknown gc_policy field"),
    ])
    def test_malformed_requests_raise_value_error(self, store, params,
                                                  fragment):
        with pytest.raises(ValueError, match=fragment):
            resolve_discovery(params, store)

    def test_host_request_keys_as_discover_host_persists(self, store):
        """A ``"host"`` request resolves with the reference's fields and
        defaults to ``discover_host``'s descriptor and store key."""
        from repro_torch.core.discover import host_request_descriptor

        descriptor, key, run = resolve_discovery({"backend": "host"}, store)
        assert descriptor == host_request_descriptor(128 * 1024**2, 9, True)
        assert key == request_key(descriptor)
        params = {"backend": "host", "max_bytes": 8 * 1024**2,
                  "n_samples": 5, "quick": False, "refresh": True,
                  "gc_policy": None}
        descriptor, key, _ = resolve_discovery(params, store)
        assert descriptor == host_request_descriptor(8 * 1024**2, 5, False)
        assert key == request_key(descriptor)
        assert callable(run)

    def test_budget_accepts_default_and_kwargs(self, store):
        _, key_none, _ = resolve_discovery(SIM_H100, store)
        _, key_dflt, _ = resolve_discovery({**SIM_H100, "budget": "default"},
                                           store)
        _, key_cfg, _ = resolve_discovery(
            {**SIM_H100, "budget": {"max_rounds": 3}}, store)
        # budgets are part of the content address
        assert len({key_none, key_dflt, key_cfg}) == 3


class TestLifecycleAndIdempotency:
    def test_submit_runs_to_done_and_writes_through(self, store):
        engine = make_engine(store).start()
        try:
            job, created = engine.submit(SIM_H100)
            assert created and job.state in ("queued", "running")
            job = engine.wait(job.job_id, timeout_s=60)
            assert job.state == "done" and job.terminal
            assert job.attempts == 1
            assert job.started_at >= job.created_at
            assert job.finished_at >= job.started_at
            assert job.result["model"] == "sim-h100"
            assert job.result["store_hit"] is False
            assert job.result["probe_rows"] > 0
            assert store.has(job.key)
        finally:
            engine.stop()

    def test_duplicate_submission_attaches_to_in_flight_job(self, store):
        engine = make_engine(store)          # never started: stays queued
        job_a, created_a = engine.submit(SIM_H100)
        job_b, created_b = engine.submit(dict(SIM_H100))
        assert created_a and not created_b
        assert job_b is job_a                # same job, not a second run
        assert engine.metrics.counters["deduplicated"] == 1
        # a *different* request gets its own job
        job_c, created_c = engine.submit({**SIM_H100, "seed": 72})
        assert created_c and job_c is not job_a

    def test_resubmit_after_done_is_a_store_hit_with_zero_probes(self, store):
        engine = make_engine(store).start()
        try:
            first = engine.wait(engine.submit(SIM_H100)[0].job_id,
                                timeout_s=60)
            assert first.result["store_hit"] is False
            second_job, created = engine.submit(SIM_H100)
            assert created                   # prior job is terminal
            second = engine.wait(second_job.job_id, timeout_s=60)
            assert second.result["store_hit"] is True
            assert second.job_id != first.job_id
            assert second.key == first.key
        finally:
            engine.stop()

    def test_job_to_json_wire_shape(self, store):
        engine = make_engine(store)
        job, _ = engine.submit(SIM_H100)
        doc = job.to_json()
        assert doc["job_id"] == job.job_id
        assert doc["state"] == "queued"
        assert doc["params"] == SIM_H100
        assert doc["backend"] == "sim"
        assert doc["result"] is None and doc["error"] is None


class TestRetryAndFailure:
    def test_transient_errors_retry_with_exponential_backoff(self, store):
        sleeps = []
        fails = {"left": 2}

        def flaky(job, attempt):
            if fails["left"] > 0:
                fails["left"] -= 1
                raise TransientRunnerError("injected blip")

        engine = make_engine(store, on_attempt=flaky, max_retries=2,
                             backoff_base_s=0.01, backoff_cap_s=10.0,
                             sleep=sleeps.append).start()
        try:
            job = engine.wait(engine.submit(SIM_H100)[0].job_id,
                              timeout_s=60)
            assert job.state == "done"
            assert job.attempts == 3
            assert sleeps == [0.01, 0.02]    # base * 2**attempt
            assert engine.metrics.counters["retries"] == 2
        finally:
            engine.stop()

    def test_backoff_is_capped(self, store):
        sleeps = []

        def flaky(job, attempt):
            if attempt < 2:
                raise TransientRunnerError("blip")

        engine = make_engine(store, on_attempt=flaky, max_retries=2,
                             backoff_base_s=1.0, backoff_cap_s=1.5,
                             sleep=sleeps.append).start()
        try:
            engine.wait(engine.submit(SIM_H100)[0].job_id, timeout_s=60)
            assert sleeps == [1.0, 1.5]      # second sleep hit the cap
        finally:
            engine.stop()

    def test_exhausted_retries_fail_with_attempt_count(self, store):
        def always(job, attempt):
            raise TransientRunnerError("persistent fault")

        engine = make_engine(store, on_attempt=always, max_retries=2,
                             sleep=lambda s: None).start()
        try:
            job = engine.wait(engine.submit(SIM_H100)[0].job_id,
                              timeout_s=60)
            assert job.state == "failed"
            assert job.attempts == 3
            assert "3 attempts" in job.error
            assert "persistent fault" in job.error
            assert engine.metrics.counters["failed"] == 1
        finally:
            engine.stop()

    def test_non_transient_errors_fail_fast_without_retry(self, store):
        def boom(job, attempt):
            raise ValueError("deterministic bug")

        engine = make_engine(store, on_attempt=boom, max_retries=5).start()
        try:
            job = engine.wait(engine.submit(SIM_H100)[0].job_id,
                              timeout_s=60)
            assert job.state == "failed"
            assert job.attempts == 1         # no retry on deterministic bugs
            assert "ValueError: deterministic bug" in job.error
            assert engine.metrics.counters["retries"] == 0
        finally:
            engine.stop()

    def test_job_timeout_marks_failed_and_counts(self, store):
        release = threading.Event()
        engine = make_engine(store, default_timeout_s=0.05, max_retries=0)
        job, _ = engine.submit(SIM_H100)
        # swap the run thunk for one that overruns the timeout, then start
        engine._runs[job.job_id] = lambda: release.wait(10)
        engine.start()
        try:
            job = engine.wait(job.job_id, timeout_s=30)
            assert job.state == "failed"
            assert "timeout" in job.error
            assert engine.metrics.counters["timeouts"] == 1
        finally:
            release.set()                    # let the abandoned thread exit
            engine.stop()


class TestCancellationAndBounds:
    def test_cancel_queued_job_is_immediate(self, store):
        engine = make_engine(store)          # not started: job stays queued
        job, _ = engine.submit(SIM_H100)
        engine.cancel(job.job_id)
        assert job.state == "cancelled"
        assert job.done_event.is_set()
        # idempotent: a second cancel leaves the terminal state alone
        engine.cancel(job.job_id)
        assert job.state == "cancelled"
        # the key is free again — a resubmission creates a fresh job
        job2, created = engine.submit(SIM_H100)
        assert created and job2.job_id != job.job_id

    def test_cancel_between_retry_attempts(self, store):
        started = threading.Event()
        cancelled = threading.Event()

        def flaky(job, attempt):
            started.set()
            raise TransientRunnerError("blip")

        # the backoff sleep parks until the cancel below has landed, so the
        # worker deterministically observes it at the top of the next attempt
        engine = make_engine(store, on_attempt=flaky, max_retries=50,
                             sleep=lambda s: cancelled.wait(10)).start()
        try:
            job, _ = engine.submit(SIM_H100)
            assert started.wait(10)
            engine.cancel(job.job_id)
            cancelled.set()
            job = engine.wait(job.job_id, timeout_s=30)
            assert job.state == "cancelled"
            assert "cancelled before attempt" in job.error
        finally:
            engine.stop()

    def test_unknown_job_raises_key_error(self, store):
        engine = make_engine(store)
        with pytest.raises(KeyError):
            engine.cancel("nope")
        with pytest.raises(KeyError):
            engine.wait("nope", timeout_s=0.1)

    def test_bounded_queue_rejects_overflow(self, store):
        engine = make_engine(store, max_queue=1)     # not started
        engine.submit(SIM_H100)
        with pytest.raises(QueueFullError):
            engine.submit({**SIM_H100, "seed": 99})
        assert engine.metrics.counters["rejected"] == 1
        # duplicates still attach even when the queue is full
        _, created = engine.submit(SIM_H100)
        assert not created

    def test_stop_cancels_queued_jobs(self, store):
        engine = make_engine(store)          # never started
        job, _ = engine.submit(SIM_H100)
        engine.stop()
        assert job.state == "cancelled"
        assert "engine stopped" in job.error

    def test_history_trims_oldest_terminal_jobs(self, store):
        engine = make_engine(store, max_history=2).start()
        try:
            ids = []
            for seed in (1, 2, 3, 4):
                job, _ = engine.submit({**SIM_H100, "seed": seed})
                engine.wait(job.job_id, timeout_s=60)
                ids.append(job.job_id)
            known = [j.job_id for j in engine.jobs()]
            assert len(known) <= 3           # trimmed at submit time
            assert ids[-1] in known          # newest survives
            assert ids[0] not in known       # oldest terminal evicted
        finally:
            engine.stop()


class TestMetrics:
    def test_stats_snapshot_shape_and_histogram(self, store):
        engine = make_engine(store).start()
        try:
            engine.wait(engine.submit(SIM_H100)[0].job_id, timeout_s=60)
        finally:
            engine.stop()
        stats = engine.stats()
        assert stats["submitted"] == 1 and stats["done"] == 1
        assert stats["workers"] == 1
        assert stats["states"] == {"done": 1}
        assert stats["duration_bucket_edges_s"] == list(JOB_LATENCY_BUCKETS_S)
        assert sum(stats["duration_buckets"]) == 1
        assert stats["duration_sum_s"] > 0

    def test_result_matches_direct_discovery(self, store):
        """The topology a job persists is bit-identical to a direct
        ``discover_sim`` of the same request (content address equality)."""
        engine = make_engine(store).start()
        try:
            job = engine.wait(engine.submit(SIM_H100)[0].job_id,
                              timeout_s=60)
        finally:
            engine.stop()
        direct_store = TopologyStore(str(store.root) + "-direct")
        topo, _ = discover_sim(make_h100_like(seed=71), n_samples=9,
                               store=direct_store)
        assert direct_store.keys() == [job.key]

        def comparable(s):
            # drop the free-text notes: they embed wall-clock timings
            return {k: v for k, v in s.get(job.key).topology.to_json().items()
                    if k != "notes"}

        assert comparable(direct_store) == comparable(store)


# ------------------------------------------------------------ the card
class TestCudaBackend:
    def test_cuda_key_equals_the_key_discover_cuda_persists_under(self,
                                                                  store):
        from repro_torch.core import discover_cuda
        from repro_torch.core.probes import CudaRunner

        params = {"backend": "cuda", "elements": ["VMEM"], "n_samples": 3}
        descriptor, key, _ = resolve_discovery(params, store)
        assert descriptor["kind"] == "discover_cuda"
        assert descriptor["budget"] is not None      # the default budget
        # the same request, run on the CPU by a caller of discover_cuda
        # (short chains; the chain length is no part of the request)
        discover_cuda(runner=CudaRunner(device="cpu", base_steps=256),
                      n_samples=3, elements=["VMEM"], store=store)
        assert store.keys() == [key]
        _, dense_key, _ = resolve_discovery({**params, "budget": None},
                                            store)
        assert dense_key != key

    def test_cuda_job_without_a_card_fails_naming_cuda(self, store):
        import torch

        from repro_torch.kernels import ops

        if torch.cuda.is_available():
            pytest.skip("a card is present: the job would measure it")
        ops.reset_launches()
        engine = make_engine(store).start()
        try:
            job = engine.wait(engine.submit({"backend": "cuda"})[0].job_id,
                              timeout_s=60)
        finally:
            engine.stop()
        assert job.state == "failed"
        assert "CUDA" in job.error
        assert all(fn.launches == 0 for fn in ops.WRAPPERS)
        assert store.keys() == []

    def test_cuda_jobs_queue_behind_each_other(self, store, monkeypatch):
        """Two workers, two "cuda" requests with different keys: the card
        lock lets one run at a time; a sim job runs beside them."""
        import time

        import importlib

        discover_module = importlib.import_module("repro_torch.core.discover")
        live, most, lock = [0], [0], threading.Lock()

        def fake_discover_cuda(model, n_samples, elements, **kw):
            with lock:
                live[0] += 1
                most[0] = max(most[0], live[0])
            time.sleep(0.2)
            with lock:
                live[0] -= 1
            return discover_sim(make_h100_like(seed=n_samples),
                                n_samples=n_samples)

        monkeypatch.setattr(discover_module, "discover_cuda",
                            fake_discover_cuda)
        engine = make_engine(store, workers=3).start()
        try:
            jobs = [engine.submit(p)[0] for p in (
                {"backend": "cuda", "n_samples": 9},
                {"backend": "cuda", "n_samples": 11}, SIM_H100)]
            done = [engine.wait(j.job_id, timeout_s=60) for j in jobs]
        finally:
            engine.stop()
        assert [j.state for j in done] == ["done"] * 3
        assert most[0] == 1
