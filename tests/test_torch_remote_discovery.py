"""The reference's live-server cases for the remote discovery write path
(``tests/test_remote_discovery.py``), re-pointed at the port.

Every test talks to a real ``TopologyHTTPServer`` on an ephemeral loopback
port.  Covers the acceptance end-to-end (submit over HTTP -> server-side
discovery -> readable via the query endpoints -> idempotent resubmit with
zero runner probes -> survives an injected transient runner fault), the
bearer-auth matrix (missing/bad/good token, mutating vs read endpoints),
HTTP cancellation, queue-full 503s, wire-format 400s, and the client's
retry/backoff loop (fault-injected 503-with-``Retry-After``, recorded
sleeps, eventual success) plus ``wait()``'s ``Retry-After`` pacing.
"""
import http.client
import json
import threading
import time

import pytest

from repro_torch.core.engine.store import TopologyStore
from repro_torch.serve import (HttpError, TopologyClient, TopologyHTTPError,
                               TopologyHTTPServer)
from repro_torch.serve.jobs import JobEngine, TransientRunnerError

TOKEN = "tok-mt4g-test"
SIM_H100 = {"backend": "sim", "device": "h100", "seed": 71, "n_samples": 9}
SIM_MI210 = {"backend": "sim", "device": "mi210", "seed": 72, "n_samples": 9}


def _raw_request(server, method, path, body=None, headers=None):
    """(status, headers, parsed body) via a bare http.client connection."""
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        if isinstance(body, dict):
            body = json.dumps(body)
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            payload = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            payload = raw
        return resp.status, dict(resp.getheaders()), payload
    finally:
        conn.close()


def _bearer(token=TOKEN):
    return {"Authorization": f"Bearer {token}",
            "Content-Type": "application/json"}


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    store = TopologyStore(str(tmp_path_factory.mktemp("remote") / "store"))
    # job_poll_s=0 keeps wait() loops tight — sim jobs finish in ~0.2s, so
    # the production 1s Retry-After hint would dominate the test wall time
    with TopologyHTTPServer(store, auth_token=TOKEN, job_workers=2,
                            job_poll_s=0) as srv:
        yield srv


@pytest.fixture
def client(server):
    return TopologyClient(server.url, auth_token=TOKEN)


class TestEndToEnd:
    def test_submit_poll_query_roundtrip(self, server, client):
        """The acceptance path: a discovery submitted over HTTP completes
        server-side and its topology is immediately readable."""
        job = client.submit_discovery(SIM_H100)
        assert job["state"] in ("queued", "running")
        assert job["deduplicated"] is False
        assert job["status_url"] == f"/discoveries/{job['job_id']}"

        final = client.wait(job["job_id"], timeout_s=60)
        assert final["state"] == "done"
        assert final["result"]["model"] == "sim-h100"
        assert final["result"]["store_hit"] is False
        assert final["result"]["probe_rows"] > 0

        # the written topology is served by the read path, same key
        keys = [t["key"] for t in client.topologies()]
        assert final["key"] in keys
        q = client.query(final["key"], "L1.size")
        assert q["found"] and q["value"] > 0

    def test_submit_returns_202_created(self, server):
        status, _, payload = _raw_request(server, "POST", "/discoveries",
                                          body=SIM_MI210, headers=_bearer())
        assert status == 202
        assert payload["deduplicated"] is False

    def test_resubmit_after_done_is_store_hit_zero_probes(self, server,
                                                          client):
        first = client.submit_and_wait(SIM_H100, timeout_s=60)
        assert first["state"] == "done"
        second = client.submit_and_wait(SIM_H100, timeout_s=60)
        assert second["state"] == "done"
        assert second["key"] == first["key"]
        assert second["result"]["store_hit"] is True   # zero runner probes

    def test_discoveries_listing_and_state_filter(self, server, client):
        client.submit_and_wait(SIM_H100, timeout_s=60)
        all_jobs = client.discoveries()
        assert all_jobs and all(j["job_id"] for j in all_jobs)
        done = client.discoveries(state="done")
        assert done and all(j["state"] == "done" for j in done)
        assert client.discoveries(state="failed") == [
            j for j in all_jobs if j["state"] == "failed"]

    def test_unknown_job_404(self, client):
        with pytest.raises(TopologyHTTPError) as ei:
            client.discovery("no-such-job")
        assert ei.value.status == 404

    def test_bad_wire_params_400_before_enqueue(self, server, client):
        before = client.metrics()["jobs"]["submitted"]
        for bad in ({"backend": "pallas"},
                    {"backend": "host", "device": "h100"},
                    {"backend": "sim", "device": "rtx5090"},
                    {"backend": "sim", "device": "h100", "n_samples": 0}):
            with pytest.raises(TopologyHTTPError) as ei:
                client.submit_discovery(bad)
            assert ei.value.status == 400
            assert "bad discovery request" in ei.value.payload["error"]
        assert client.metrics()["jobs"]["submitted"] == before

    def test_job_metrics_in_metrics_endpoint(self, server, client):
        client.submit_and_wait(SIM_H100, timeout_s=60)
        jobs = client.metrics()["jobs"]
        assert jobs["submitted"] >= 1 and jobs["done"] >= 1
        assert jobs["workers"] == 2
        assert len(jobs["duration_buckets"]) == \
            len(jobs["duration_bucket_edges_s"]) + 1
        assert sum(jobs["duration_buckets"]) == jobs["done"] + jobs["failed"]

    def test_healthz_reports_job_queue(self, client):
        h = client.healthz()
        assert h["jobs_enabled"] is True
        assert h["job_queue_depth"] == 0


class TestAuthMatrix:
    """Mutating endpoints require the bearer token; reads stay open."""

    MUTATING = [("POST", "/discoveries", SIM_H100),
                ("DELETE", "/discoveries/abc123", None)]
    READ = ["/healthz", "/metrics", "/topologies", "/discoveries"]

    @pytest.mark.parametrize("method, path, body", MUTATING)
    def test_missing_token_401_with_challenge(self, server, method, path,
                                              body):
        status, headers, payload = _raw_request(
            server, method, path, body=body,
            headers={"Content-Type": "application/json"} if body else None)
        assert status == 401
        assert "Bearer" in headers.get("WWW-Authenticate", "")
        assert "bearer token" in payload["error"]

    @pytest.mark.parametrize("method, path, body", MUTATING)
    def test_bad_token_401(self, server, method, path, body):
        status, _, _ = _raw_request(server, method, path, body=body,
                                    headers=_bearer("wrong-token"))
        assert status == 401

    def test_good_token_accepted_on_mutating(self, server):
        status, _, payload = _raw_request(server, "POST", "/discoveries",
                                          body=SIM_H100, headers=_bearer())
        assert status in (200, 202)          # accepted (created or attached)
        # DELETE with a good token reaches the handler (404 = unknown id,
        # i.e. auth passed)
        status, _, _ = _raw_request(server, "DELETE", "/discoveries/zzz",
                                    headers=_bearer())
        assert status == 404

    @pytest.mark.parametrize("path", READ)
    def test_reads_stay_open_without_token(self, server, path):
        status, _, _ = _raw_request(server, "GET", path)
        assert status == 200

    def test_client_sends_token_on_every_request(self, server):
        # a tokenless client can read but not submit
        anon = TopologyClient(server.url)
        assert anon.healthz()["status"] == "ok"
        with pytest.raises(TopologyHTTPError) as ei:
            anon.submit_discovery(SIM_H100)
        assert ei.value.status == 401


class TestCancelAndQueueBounds:
    """These need a wedged worker, so they build their own small server."""

    @pytest.fixture
    def wedged(self, tmp_path):
        release = threading.Event()
        running = threading.Event()

        def block(job, attempt):
            running.set()
            release.wait(30)

        store = TopologyStore(str(tmp_path / "store"))
        engine = JobEngine(store, workers=1, max_queue=2, on_attempt=block)
        srv = TopologyHTTPServer(store, auth_token=TOKEN, job_engine=engine)
        srv.start()
        try:
            yield srv, running, release
        finally:
            release.set()
            srv.stop()

    def test_cancel_queued_job_over_http(self, wedged):
        srv, running, _ = wedged
        c = TopologyClient(srv.url, auth_token=TOKEN)
        c.submit_discovery(SIM_H100)         # occupies the only worker
        assert running.wait(10)
        queued = c.submit_discovery(SIM_MI210)
        assert queued["state"] == "queued"
        out = c.cancel_discovery(queued["job_id"])
        assert out["state"] == "cancelled"
        # idempotent: cancelling again keeps the terminal state
        again = c.cancel_discovery(queued["job_id"])
        assert again["state"] == "cancelled"

    def test_duplicate_submission_attaches_200(self, wedged):
        srv, running, _ = wedged
        c = TopologyClient(srv.url, auth_token=TOKEN)
        first = c.submit_discovery(SIM_H100)
        assert running.wait(10)
        status, _, payload = _raw_request(srv, "POST", "/discoveries",
                                          body=SIM_H100, headers=_bearer())
        assert status == 200                 # attached, not created
        assert payload["deduplicated"] is True
        assert payload["job_id"] == first["job_id"]

    def test_queue_full_503_with_retry_after(self, wedged):
        srv, running, _ = wedged
        c = TopologyClient(srv.url, auth_token=TOKEN)
        c.submit_discovery(SIM_H100)         # worker wedges on this one
        assert running.wait(10)
        c.submit_discovery(SIM_MI210)        # queue slot 1
        c.submit_discovery({**SIM_H100, "seed": 5})      # queue slot 2
        with pytest.raises(TopologyHTTPError) as ei:
            c.submit_discovery({**SIM_H100, "seed": 6})
        assert ei.value.status == 503
        assert ei.value.retry_after_s is not None
        assert "queue full" in ei.value.payload["error"]


class TestClientRetryBackoff:
    """Fault-injecting server: the first N requests get a 503 (optionally
    with ``Retry-After``), later ones pass through."""

    @pytest.fixture
    def flaky_server(self, tmp_path):
        state = {"fail": 0, "retry_after": None, "seen": 0}

        def hook(method, path):
            state["seen"] += 1
            if state["fail"] > 0:
                state["fail"] -= 1
                raise HttpError(503, "injected overload",
                                retry_after_s=state["retry_after"])

        store = TopologyStore(str(tmp_path / "store"))
        srv = TopologyHTTPServer(store, on_request=hook, jobs=True)
        srv.start()
        try:
            yield srv, state
        finally:
            state["fail"] = 0
            srv.stop()

    def test_retry_honors_retry_after_then_succeeds(self, flaky_server):
        srv, state = flaky_server
        state.update(fail=2, retry_after=3)
        sleeps = []
        c = TopologyClient(srv.url, max_retries=3, sleep=sleeps.append)
        assert c.healthz()["status"] == "ok"             # eventual success
        assert sleeps == [3.0, 3.0]          # server-provided pacing, bounded
        assert state["seen"] == 3

    def test_retry_exponential_backoff_without_retry_after(self,
                                                           flaky_server):
        srv, state = flaky_server
        state.update(fail=3, retry_after=None)
        sleeps = []
        c = TopologyClient(srv.url, max_retries=3, backoff_base_s=0.05,
                           backoff_cap_s=0.15, sleep=sleeps.append)
        assert c.healthz()["status"] == "ok"
        assert sleeps == [0.05, 0.1, 0.15]   # base*2**i, capped
        assert state["seen"] == 4

    def test_no_retries_by_default(self, flaky_server):
        srv, state = flaky_server
        state.update(fail=1, retry_after=1)
        c = TopologyClient(srv.url)          # max_retries=0
        with pytest.raises(TopologyHTTPError) as ei:
            c.healthz()
        assert ei.value.status == 503
        assert ei.value.retry_after_s == 1.0
        assert state["seen"] == 1

    def test_retries_exhausted_raises_the_503(self, flaky_server):
        srv, state = flaky_server
        state.update(fail=10, retry_after=None)
        sleeps = []
        c = TopologyClient(srv.url, max_retries=2, backoff_base_s=0.01,
                           sleep=sleeps.append)
        with pytest.raises(TopologyHTTPError) as ei:
            c.healthz()
        assert ei.value.status == 503
        assert len(sleeps) == 2              # bounded: max_retries sleeps
        assert state["seen"] == 3

    def test_non_503_errors_are_not_retried(self, flaky_server):
        srv, state = flaky_server
        state.update(fail=0)
        sleeps = []
        c = TopologyClient(srv.url, max_retries=5, sleep=sleeps.append)
        with pytest.raises(TopologyHTTPError) as ei:
            c.topology("no-such-key")
        assert ei.value.status == 404
        assert sleeps == []


class TestWaitPacing:
    def test_wait_paces_polls_by_retry_after_header(self, tmp_path):
        """Unfinished job polls carry ``Retry-After``; ``wait`` must sleep
        that hint, not its default poll interval."""
        release = threading.Event()
        running = threading.Event()

        def block(job, attempt):
            running.set()
            release.wait(30)

        store = TopologyStore(str(tmp_path / "store"))
        engine = JobEngine(store, workers=1, on_attempt=block)
        srv = TopologyHTTPServer(store, job_engine=engine, job_poll_s=3)
        srv.start()
        sleeps = []

        def fake_sleep(s):
            sleeps.append(s)
            release.set()                    # un-wedge after the first poll
            time.sleep(0.02)

        try:
            c = TopologyClient(srv.url, sleep=fake_sleep)
            job = c.submit_discovery(SIM_H100)
            # header check on a raw poll while the job is still live
            status, headers, _ = _raw_request(
                srv, "GET", f"/discoveries/{job['job_id']}")
            assert status == 200
            if not release.is_set():         # job may already be terminal
                assert headers.get("Retry-After") == "3"
            final = c.wait(job["job_id"], timeout_s=60, poll_s=0.5)
            assert final["state"] == "done"
            assert all(s == 3.0 for s in sleeps)     # header, not poll_s
        finally:
            release.set()
            srv.stop()

    def test_wait_timeout_raises(self, tmp_path):
        release = threading.Event()

        def block(job, attempt):
            release.wait(30)

        store = TopologyStore(str(tmp_path / "store"))
        engine = JobEngine(store, workers=1, on_attempt=block)
        srv = TopologyHTTPServer(store, job_engine=engine, job_poll_s=0)
        srv.start()
        try:
            c = TopologyClient(srv.url)
            job = c.submit_discovery(SIM_H100)
            with pytest.raises(TimeoutError):
                c.wait(job["job_id"], timeout_s=0.3, poll_s=0.05)
        finally:
            release.set()
            srv.stop()


def test_host_job_answered_then_served_from_the_store(server, client,
                                                      monkeypatch):
    """A ``"host"`` job at 8 MiB runs ``discover_host`` server-side, is
    readable through the query endpoints, and its resubmit is a store hit
    that builds no runner."""
    import importlib

    host = {"backend": "host", "max_bytes": 8 * 1024**2, "n_samples": 5}
    first = client.submit_and_wait(host, timeout_s=120)
    assert first["state"] == "done", first.get("error")
    assert first["result"]["store_hit"] is False
    assert first["result"]["model"] == "cpu"
    topo = client.topology(first["key"])["topology"]
    assert [m["name"] for m in topo["memory"]] == ["host-cache", "DRAM"]
    q = client.query(first["key"], "DRAM.read_bw")
    assert q["found"] and q["value"] > 0

    discover_module = importlib.import_module("repro_torch.core.discover")
    monkeypatch.setattr(discover_module, "HostRunner", None)   # no probe
    second = client.submit_and_wait(host, timeout_s=60)
    assert second["state"] == "done", second.get("error")
    assert second["key"] == first["key"]
    assert second["result"]["store_hit"] is True
