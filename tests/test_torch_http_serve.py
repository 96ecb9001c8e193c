"""The reference's live-server cases for the HTTP topology front end
(``tests/test_http_serve.py``), re-pointed at the port.

Every test runs against a real ``TopologyHTTPServer`` bound to an ephemeral
loopback port: endpoint contracts, the structured error mapping
(400/404/405/411/413/503), traffic hardening, graceful-shutdown draining,
and the acceptance end-to-end — concurrent multi-threaded traffic over
every endpoint followed by a ``refresh=True`` rewrite that must be served
fresh (no stale LRU read) with zero 5xx responses.
"""
import http.client
import json
import threading
import time

import pytest

from repro_torch.core import discover_sim, make_h100_like, make_mi210_like
from repro_torch.core.engine.store import TopologyStore
from repro_torch.serve import (TopologyClient, TopologyHTTPError,
                               TopologyHTTPServer)

KIB = 1024


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    store = TopologyStore(str(tmp_path_factory.mktemp("http") / "store"))
    discover_sim(make_h100_like(seed=81), n_samples=9, store=store)
    discover_sim(make_mi210_like(seed=82), n_samples=9, store=store)
    return store


@pytest.fixture(scope="module")
def server(store):
    with TopologyHTTPServer(store) as srv:
        yield srv


@pytest.fixture
def client(server):
    return TopologyClient(server.url)


def _key_of(store, model):
    return next(k for k, meta in store.index() if meta["model"] == model)


def _raw_request(server, method, path, body=None, headers=None):
    """(status, headers, parsed-or-raw body) via a bare http.client."""
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
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


class TestEndpoints:
    def test_healthz(self, client):
        h = client.healthz()
        assert h["status"] == "ok"
        assert h["entries"] == 2
        assert h["draining"] is False

    def test_topologies_lists_keys_and_meta(self, client, store):
        tops = client.topologies()
        assert {t["key"] for t in tops} == set(store.keys())
        assert {t["meta"]["model"] for t in tops} == {"sim-h100", "sim-mi210"}

    def test_full_topology_document(self, client, store):
        k = _key_of(store, "sim-h100")
        doc = client.topology(k)
        assert doc["key"] == k
        assert doc["topology"] == store.get(k).topology.to_json()

    def test_query_value_and_aliases(self, client, store):
        k = _key_of(store, "sim-h100")
        q = client.query(k, "L1.size")
        assert q["found"] and q["element"] == "L1" and q["unit"] == "B"
        assert abs(q["value"] - 238 * KIB) <= 4 * KIB
        assert q["provenance"] == "benchmark"
        # aliases resolve over HTTP exactly as in-process
        assert client.query(k, "hbm.bandwidth")["element"] == "DeviceMemory"
        assert client.query(k, "general.clock_domain")["value"] == "cycles"

    def test_unresolvable_path_is_found_false_not_an_error(self, client,
                                                           store):
        q = client.query(_key_of(store, "sim-h100"), "L1.no_such_attr")
        assert q["found"] is False

    def test_query_batch_alignment_and_misses(self, client, store):
        k1, k2 = _key_of(store, "sim-h100"), _key_of(store, "sim-mi210")
        pairs = [(k1, "L2.load_latency"), (k2, "vL1.size"),
                 (k1, "nope.nope"), ("unknown-key", "L1.size")]
        results = client.query_batch(pairs)
        assert len(results) == len(pairs)
        assert [r["found"] for r in results] == [True, True, False, False]
        for (k, p), r in zip(pairs, results):
            assert (r["key"], r["path"]) == (k, p)

    def test_attribute_filters(self, client, store):
        k = _key_of(store, "sim-h100")
        api = client.attributes(k, provenance="api")
        assert api and all(a["provenance"] == "api" for a in api)
        confident = client.attributes(k, min_confidence=0.9)
        assert confident
        assert all(a["confidence"] >= 0.9 for a in confident)

    def test_adjacency(self, client, store):
        adj = client.adjacency(_key_of(store, "sim-h100"))
        assert set(adj["L1"]) >= {"Texture", "Readonly"}

    def test_diff(self, client, store):
        d = client.diff(_key_of(store, "sim-h100"),
                        _key_of(store, "sim-mi210"))
        assert d["identical"] is False
        assert "L1" in d["only_in_a"] and "vL1" in d["only_in_b"]
        assert any(c["element"] == "L2" and c["attr"] == "load_latency"
                   for c in d["changed"])

    def test_metrics_shape(self, client, store):
        client.query(_key_of(store, "sim-h100"), "L1.size")
        m = client.metrics()
        assert m["service"]["lru_hits"] + m["service"]["lru_misses"] > 0
        ep = m["endpoints"]["/topologies/{key}/query"]
        assert ep["requests"] >= 1
        assert sum(ep["latency_buckets_us"]) == ep["requests"]
        assert len(ep["latency_buckets_us"]) == \
            len(m["latency_bucket_edges_us"]) + 1
        assert m["statuses"].get("2xx", 0) >= 1


class TestErrorMapping:
    def test_missing_path_param_400(self, client, store):
        with pytest.raises(TopologyHTTPError) as e:
            client.query(_key_of(store, "sim-h100"), "")
        assert e.value.status == 400

    def test_unknown_key_404(self, client):
        with pytest.raises(TopologyHTTPError) as e:
            client.query("no-such-key", "L1.size")
        assert e.value.status == 404
        assert "unknown topology key" in e.value.payload["error"]

    def test_unknown_endpoint_404(self, server):
        status, _, payload = _raw_request(server, "GET", "/no/such/route")
        assert status == 404 and "no such endpoint" in payload["error"]

    def test_wrong_method_405(self, server):
        status, _, _ = _raw_request(server, "GET", "/query_batch")
        assert status == 405
        status, _, _ = _raw_request(server, "POST", "/healthz")
        assert status == 405

    def test_malformed_json_400(self, server):
        status, _, payload = _raw_request(
            server, "POST", "/query_batch", body=b"{not json",
            headers={"Content-Length": "9"})
        assert status == 400 and "malformed JSON" in payload["error"]

    def test_bad_batch_shape_400(self, client):
        with pytest.raises(TopologyHTTPError) as e:
            client._request("/query_batch", body={"requests": [["only-key"]]})
        assert e.value.status == 400

    def test_non_numeric_min_confidence_400(self, client, store):
        with pytest.raises(TopologyHTTPError) as e:
            client.attributes(_key_of(store, "sim-h100"),
                              min_confidence="high")
        assert e.value.status == 400

    def test_diff_missing_params_400(self, client):
        with pytest.raises(TopologyHTTPError) as e:
            client._request("/diff", params={"a": "only-one"})
        assert e.value.status == 400

    def test_oversized_body_413(self, store, tmp_path):
        entry = store.get(store.keys()[0])
        small_store = TopologyStore(str(tmp_path / "small"))
        small_store.put("k", entry.topology)
        with TopologyHTTPServer(small_store, max_body_bytes=2048) as srv:
            client = TopologyClient(srv.url)
            with pytest.raises(TopologyHTTPError) as e:
                client.query_batch([("k", "L1.size")] * 300)
            assert e.value.status == 413
            # the server stays healthy after refusing the body
            assert client.healthz()["status"] == "ok"

    def test_quarantined_entry_503_with_retry_hint(self, store, tmp_path):
        entry = store.get(store.keys()[0])
        qstore = TopologyStore(str(tmp_path / "quarantine"))
        qstore.put("qkey", entry.topology)
        with TopologyHTTPServer(qstore, retry_after_s=7) as srv:
            client = TopologyClient(srv.url)
            assert client.query("qkey", "L1.size")["found"]
            with open(qstore._topo_path("qkey"), "w") as f:
                f.write("{corrupt garbage")
            # first read quarantines the damaged file...
            with pytest.raises(TopologyHTTPError) as e:
                client.query("qkey", "L1.size")
            assert e.value.status == 503
            assert e.value.retry_after_s == 7
            assert "quarantined" in e.value.payload["error"]
            # ...and the key keeps answering 503 (retry-later), not 404
            with pytest.raises(TopologyHTTPError) as e:
                client.query("qkey", "L1.size")
            assert e.value.status == 503
            # re-discovery repopulates: back to 200
            qstore.put("qkey", entry.topology)
            assert client.query("qkey", "L1.size")["found"]


class TestConcurrentServing:
    """The acceptance end-to-end: >=8 threads over every endpoint,
    then a refresh of one topology that must be served fresh, with zero
    5xx anywhere."""

    N_THREADS = 8
    REQS_PER_THREAD = 25

    def test_concurrent_traffic_then_refresh_no_stale_reads(self, tmp_path):
        store = TopologyStore(str(tmp_path / "e2e"))
        discover_sim(make_h100_like(seed=83), n_samples=9, store=store)
        discover_sim(make_mi210_like(seed=84), n_samples=9, store=store)
        k1, k2 = (_key_of(store, "sim-h100"), _key_of(store, "sim-mi210"))

        with TopologyHTTPServer(store, hot_set=4) as server:
            client = TopologyClient(server.url)
            errors: list[Exception] = []

            def workload(tid: int) -> None:
                c = TopologyClient(server.url)
                for i in range(self.REQS_PER_THREAD):
                    try:
                        c.healthz()
                        c.topologies()
                        assert c.query(k1, "L1.size")["found"]
                        assert c.query(k2, "vL1.size")["found"]
                        batch = c.query_batch(
                            [(k1, "L2.load_latency"), (k2, "hbm.bandwidth"),
                             (k1, "general.clock_domain")] * 4)
                        assert all(r["found"] for r in batch)
                        assert c.attributes(k1, provenance="benchmark")
                        assert c.adjacency(k1)
                        assert c.diff(k1, k2)["identical"] is False
                        c.metrics()
                    except Exception as e:   # noqa: BLE001 — collected
                        errors.append(e)

            threads = [threading.Thread(target=workload, args=(i,))
                       for i in range(self.N_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not errors, f"concurrent traffic failed: {errors[:3]}"

            # Service counters survived the hammer coherently.
            svc = server.service.stats()
            assert svc["lru_hits"] + svc["lru_misses"] >= \
                self.N_THREADS * self.REQS_PER_THREAD

            # -- refresh one topology under the live server (same request,
            # so the re-measured values match; the service must RELOAD, not
            # serve the hot cached object of the dead generation).
            before = client.metrics()["service"]["lru_misses"]
            v_before = client.query(k1, "L1.size")["value"]
            discover_sim(make_h100_like(seed=83), n_samples=9, store=store,
                         refresh=True)
            v_after = client.query(k1, "L1.size")["value"]
            assert v_after == v_before
            assert client.metrics()["service"]["lru_misses"] > before

            # -- a divergent rewrite (what a new firmware run looks
            # like) must be visible immediately: no stale LRU read.
            entry = store.get(k1)
            entry.topology.find_memory("L1").set(
                "load_latency", 4242.5, "cyc", "benchmark")
            store.put(k1, entry.topology, meta=entry.meta)
            assert client.query(k1, "L1.load_latency")["value"] == 4242.5

            # Zero 5xx across everything this server handled.
            statuses = client.metrics()["statuses"]
            assert statuses.get("5xx", 0) == 0
            assert statuses.get("2xx", 0) > 0


class TestGracefulShutdown:
    def test_stop_drains_in_flight_requests(self, store):
        release = threading.Event()

        def slow_hook(method, path):
            if path == "/healthz":
                release.wait(timeout=10)

        server = TopologyHTTPServer(store, on_request=slow_hook)
        server.start()
        result: dict = {}

        def request():
            result["health"] = TopologyClient(server.url).healthz()

        t = threading.Thread(target=request)
        t.start()
        time.sleep(0.2)                    # request is now in-flight, parked

        stopper = threading.Thread(target=server.stop)
        stopper.start()
        time.sleep(0.2)
        assert stopper.is_alive()          # stop() is draining, not killing
        release.set()
        stopper.join(timeout=10)
        assert not stopper.is_alive()
        t.join(timeout=10)
        # the in-flight request completed normally during the drain
        assert result["health"]["status"] == "ok"

    def test_stopped_server_refuses_connections(self, store):
        server = TopologyHTTPServer(store).start()
        url = server.url
        assert TopologyClient(url).healthz()["status"] == "ok"
        server.stop()
        with pytest.raises(OSError):
            TopologyClient(url, timeout_s=2).healthz()
