"""The port's worker-process pool against the reference package's.

``TestParallelDispatch`` is the reference's class of
``tests/test_runner_protocol.py`` re-pointed at ``repro_torch``, with
``test_host_structural_through_pool`` on the port's ``HostRunner``.  Every
pool here is closed by its fixture or ``with``
block, answers within 30 s or is killed (``call_timeout_s``), has at most
two workers, and leaves no shared-memory segment behind (checked after
each test).  Beside it: pooled port rows and pooled port discoveries equal
the reference's inline ones bit for bit, the CUDA runner stays inline, a
job engine threads its pool config into its jobs, and the modules a worker
imports, a host runner's chase included, pull in neither ``torch`` nor
``jax``.
"""
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import discover_sim as ref_discover_sim
from repro.core import make_h100_like as ref_h100
from repro.core.engine.parallel import \
    effective_cpu_count as ref_effective_cpu_count
from repro.core.probes import SimRunner as RefSimRunner
from repro_torch.core import make_h100_like
from repro_torch.core.discover import (DiscoveryRequest, discover,
                                       discover_sim, sim_request_descriptor)
from repro_torch.core.engine import parallel as parallel_module
from repro_torch.core.engine.cache import CachingRunner
from repro_torch.core.engine.parallel import (ParallelConfig, ParallelPool,
                                              effective_cpu_count,
                                              get_global_pool,
                                              maybe_parallel_runner,
                                              shutdown_global_pools)
from repro_torch.core.errors import Resilience, TransientRunnerError
from repro_torch.core.probes import (ChaosRunner, FaultSchedule, HostRunner,
                                     SimRunner)
from repro_torch.core.topology import topology_equivalent

KIB, MIB = 1024, 1024**2
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


# workers=2 with a one-row shard floor forces every multi-row batch to
# actually split across processes — the strongest form of the sharded ==
# inline claim.  Explicit ``workers`` bypasses the effective-core floor so
# the suite exercises real pooling even on a 1-2 core CI box.
PCFG = ParallelConfig(workers=2, min_rows_per_shard=1, call_timeout_s=30.0)

DEVICE_FAMILIES = ("sharing", "device_memory_latency",
                   "device_memory_bandwidth")


def _shm_residue(prefix):
    """Shared-memory segment names under /dev/shm carrying ``prefix``.

    Empty on platforms that mount no /dev/shm — the residue backstop is
    POSIX-shm specific, and so is the leak it guards against.
    """
    if not os.path.isdir("/dev/shm"):
        return []
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


@pytest.fixture(scope="module")
def pool():
    """One dedicated pool for the conformance tests (isolated lifecycle)."""
    with ParallelPool(PCFG) as p:
        yield p


# Deterministic request-keyed runners: sharding must be byte-for-byte
# invisible.  The "caching" row wraps the sim runner in ``CachingRunner``,
# whose ``runner_spec`` delegates to its base — workers rebuild the bare
# runner and the cache stays coordinator-side.
DET_RUNNERS = [
    pytest.param(lambda: SimRunner(make_h100_like(seed=3)), id="sim"),
    pytest.param(lambda: ChaosRunner(SimRunner(make_h100_like(seed=3)),
                                     FaultSchedule(seed=1)), id="chaos"),
    pytest.param(lambda: CachingRunner(SimRunner(make_h100_like(seed=3))),
                 id="caching"),
]


def _eviction_reqs(runner):
    """A mixed amount/sharing request grid big enough to shard."""
    reqs = []
    amount = [i for i in runner.spaces() if i.supports_amount][0]
    ab = min(amount.max_bytes // 8, 64 * KIB)
    reqs += [("amount", amount.name, 0, w, ab) for w in range(4)]
    sharing = [i for i in runner.spaces() if i.supports_sharing][0]
    sab = min(sharing.max_bytes // 8, 64 * KIB)
    reqs += [("sharing", sharing.name, sharing.name, sab),
             ("sharing", sharing.name, sharing.name, sab // 2)]
    return reqs


class TestParallelDispatch:
    """Sharded pool execution == inline execution, byte for byte.

    The pool's whole correctness argument rests on request-keyed sampling:
    each probe row derives its stream from (request, sample index) alone,
    so *where* the row runs cannot matter.  These tests pin that down for
    every pooled capability and every spec-publishing runner, then check
    the failure half of the contract: worker death surfaces as
    ``TransientRunnerError`` (the resilience currency), the pool respawns,
    and no shared-memory segment outlives its call.
    """

    @pytest.mark.parametrize("make", DET_RUNNERS)
    def test_five_capabilities_bit_identical(self, pool, make):
        inline = make()
        pooled = maybe_parallel_runner(make(), PCFG, pool=pool)
        assert pooled is not inline and pooled.deterministic

        sizes = [16 * KIB + 4 * KIB * i for i in range(9)]
        assert np.array_equal(inline.pchase_batch("L1", sizes, 32, 7),
                              pooled.pchase_batch("L1", sizes, 32, 7))

        strides = [8 * (i + 1) for i in range(9)]
        assert np.array_equal(
            inline.cold_chase_batch("L1", [64 * KIB] * 9, strides, 7),
            pooled.cold_chase_batch("L1", [64 * KIB] * 9, strides, 7))

        reqs = ([("L1", 16 * KIB + 4 * KIB * i, 32) for i in range(6)]
                + [("L2", MIB + 256 * KIB * i, 64) for i in range(3)])
        assert np.array_equal(inline.pchase_many(reqs, 7),
                              pooled.pchase_many(reqs, 7))
        assert np.array_equal(inline.cold_chase_many(reqs, 7),
                              pooled.cold_chase_many(reqs, 7))

        ev = _eviction_reqs(inline)
        assert np.array_equal(inline.eviction_many(ev, 7),
                              pooled.eviction_many(ev, 7))

    def test_batches_actually_shard_across_workers(self, pool):
        pooled = maybe_parallel_runner(SimRunner(make_h100_like(seed=3)),
                                       PCFG, pool=pool)
        calls0, shards0 = pool.calls, pool.shards
        pooled.pchase_many([("L1", 32 * KIB + 4 * KIB * i, 32)
                            for i in range(16)], 5)
        assert pool.calls == calls0 + 1
        assert pool.shards == shards0 + 2       # both workers took rows
        # A single-row batch cannot split below one row per shard.
        pooled.pchase_many([("L1", 32 * KIB, 32)], 5)
        assert pool.shards == shards0 + 3

    def test_host_structural_through_pool(self, pool):
        """Measuring runners pool too — structurally, never bit-for-bit."""
        pooled = maybe_parallel_runner(
            HostRunner(max_bytes=8 * MIB, iters=1 << 10), PCFG, pool=pool)
        info = pooled.spaces()[0]
        ab = min(info.max_bytes // 8, 64 * KIB)
        rows = np.asarray(pooled.pchase_many(
            [(info.name, ab, 64), (info.name, ab // 2, 64)], 3))
        assert rows.shape == (2, 3) and rows.dtype == np.float64
        assert np.all(np.isfinite(rows)) and np.all(rows > 0)
        # Capability refusals keep their exception type across the pool.
        with pytest.raises(NotImplementedError):
            pooled.cold_chase_many([(info.name, ab, 64)], 3)

    def test_caching_over_pool_serves_repeats_locally(self, pool):
        """Engine ordering: cache above the pool, misses-only cross over."""
        reqs = [("L1", 16 * KIB + 4 * KIB * i, 32) for i in range(8)]
        inline = CachingRunner(SimRunner(make_h100_like(seed=3)))
        cached = CachingRunner(maybe_parallel_runner(
            SimRunner(make_h100_like(seed=3)), PCFG, pool=pool))
        assert np.array_equal(inline.pchase_many(reqs, 7),
                              cached.pchase_many(reqs, 7))
        calls0 = pool.calls
        cached.pchase_many(reqs, 7)             # all rows now cached
        assert pool.calls == calls0

    def test_specless_or_disabled_stays_inline(self):
        runner = SimRunner(make_h100_like(seed=3))
        assert maybe_parallel_runner(runner, None) is runner
        # No RunnerSpec -> identity, even with pooling requested.
        bare = object()
        assert maybe_parallel_runner(bare, PCFG) is bare
        # Below the effective-core floor the auto heuristic opts out...
        auto = ParallelConfig(min_cores=10 ** 6)
        assert auto.resolved_workers() == 0
        assert maybe_parallel_runner(runner, auto) is runner
        # ...but an explicit worker count always pools.
        assert ParallelConfig(workers=3, min_cores=10 ** 6)
        assert ParallelConfig(workers=3,
                              min_cores=10 ** 6).resolved_workers() == 3

    def test_effective_cpu_count_sane(self):
        n = effective_cpu_count()
        assert 1 <= n <= (os.cpu_count() or 1)

    def test_worker_crash_transient_respawn_no_residue(self):
        """A killed worker costs one TransientRunnerError, nothing else."""
        cfg = ParallelConfig(workers=1, min_rows_per_shard=1,
                             call_timeout_s=30.0)
        with ParallelPool(cfg) as crash_pool:
            prefix = crash_pool._prefix
            chaos = ChaosRunner(SimRunner(make_h100_like(seed=3)),
                                FaultSchedule(kill_worker_after=0))
            pooled = maybe_parallel_runner(chaos, cfg, pool=crash_pool)
            with pytest.raises(TransientRunnerError):
                pooled.pchase_many([("L1", 64 * KIB, 32)], 5)
            assert crash_pool.respawns == 1
            # Segment released despite the abnormal exit, pool still live.
            assert _shm_residue(prefix) == []
            clean = maybe_parallel_runner(SimRunner(make_h100_like(seed=3)),
                                          cfg, pool=crash_pool)
            rows = np.asarray(clean.pchase_many([("L1", 64 * KIB, 32)], 5))
            assert rows.shape == (1, 5)
        assert _shm_residue(prefix) == []

    def test_worker_kill_discovery_recovers_clean_topology(self):
        """Mid-round worker death -> resilience retry -> clean topology.

        The chaos schedule kills the worker process a few calls in (the
        ``MT4G_POOL_WORKER`` guard keeps the coordinator alive); the pooled
        fused discovery must converge to exactly the inline clean run —
        everything but the wall-time note, which legitimately differs.
        """
        dev = make_h100_like(seed=3)
        policy = Resilience(max_retries=4, sleep=lambda _s: None)

        def req(make_runner, **kw):
            return DiscoveryRequest(
                descriptor=sim_request_descriptor(dev, 9, None),
                vendor=dev.vendor, model=dev.name,
                backend=f"simulated:{dev.name}",
                make_runner=make_runner, n_samples=9,
                device_families=DEVICE_FAMILIES, fuse=True, **kw)

        clean, _ = discover(req(lambda: SimRunner(dev)))

        sched = FaultSchedule(kill_worker_after=6)
        shared = get_global_pool(PCFG)
        respawns0 = shared.respawns
        try:
            topo, _ = discover(req(
                lambda: ChaosRunner(SimRunner(dev), sched),
                resilience=policy, parallel=PCFG))
        finally:
            shutdown_global_pools()
        assert shared.respawns > respawns0      # kills actually happened
        assert topology_equivalent(clean, topo)
        a, b = clean.to_json(), topo.to_json()
        a.pop("notes"), b.pop("notes")
        assert a == b
        assert _shm_residue(f"mt4g{os.getpid()}") == []



@pytest.fixture(autouse=True)
def no_residue():
    """No test leaves a pool segment of this process in /dev/shm."""
    yield
    assert _shm_residue(f"mt4g{os.getpid()}p") == []


@pytest.fixture
def global_pools():
    """Tests that go through the shared pool close it when they end."""
    yield
    shutdown_global_pools()
    assert not parallel_module._POOLS


def _without_notes(topo) -> dict:
    doc = topo.to_json()
    doc.pop("notes")
    return doc


class TestAgainstReference:
    @pytest.mark.parametrize("make", DET_RUNNERS)
    def test_pooled_rows_equal_reference_inline(self, pool, make):
        """The port's sharded rows are the reference's inline rows."""
        pooled = maybe_parallel_runner(make(), PCFG, pool=pool)
        ref = RefSimRunner(ref_h100(seed=3))
        sizes = [16 * KIB + 4 * KIB * i for i in range(9)]
        reqs = ([("L1", 16 * KIB + 4 * KIB * i, 32) for i in range(6)]
                + [("L2", MIB + 256 * KIB * i, 64) for i in range(3)])
        ev = _eviction_reqs(ref)
        for got, want in [
                (pooled.pchase_batch("L1", sizes, 32, 7),
                 ref.pchase_batch("L1", sizes, 32, 7)),
                (pooled.cold_chase_batch("L1", [64 * KIB] * 9,
                                         [8 * (i + 1) for i in range(9)], 7),
                 ref.cold_chase_batch("L1", [64 * KIB] * 9,
                                      [8 * (i + 1) for i in range(9)], 7)),
                (pooled.pchase_many(reqs, 7), ref.pchase_many(reqs, 7)),
                (pooled.cold_chase_many(reqs, 7),
                 ref.cold_chase_many(reqs, 7)),
                (pooled.eviction_many(ev, 7), ref.eviction_many(ev, 7))]:
            assert np.array_equal(np.asarray(got), np.asarray(want))

    @pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
    def test_pooled_discovery_equals_reference(self, fuse, global_pools):
        """``discover_sim(parallel=...)`` equals the reference's inline run
        bit for bit: topology, cache counts, and no worker respawned."""
        got, t = discover_sim(make_h100_like(seed=3), n_samples=9,
                              fuse=fuse, parallel=PCFG)
        want, wt = ref_discover_sim(ref_h100(seed=3), n_samples=9,
                                    fuse=fuse)
        pool = get_global_pool(PCFG)
        assert pool.calls > 0 and pool.respawns == 0
        assert _without_notes(got) == _without_notes(want)
        assert t.meta["cache"] == wt.meta["cache"]

    def test_effective_cpu_count_equals_reference(self):
        assert effective_cpu_count() == ref_effective_cpu_count()


def test_cuda_runner_stays_inline():
    """The CUDA runner publishes no ``RunnerSpec`` — bare, under chaos or
    under the cache — so pooling is the identity and spawns nothing."""
    from repro_torch.core.probes import CudaRunner

    children = set(multiprocessing.active_children())
    cuda = CudaRunner(device="cpu")
    assert getattr(cuda, "runner_spec", None) is None
    for runner in (cuda, ChaosRunner(cuda, FaultSchedule(seed=1)),
                   CachingRunner(cuda)):
        assert maybe_parallel_runner(runner, PCFG) is runner
    assert not parallel_module._POOLS
    assert set(multiprocessing.active_children()) == children


def test_job_engine_threads_its_pool_config(tmp_path, global_pools):
    """A ``JobEngine(parallel=...)`` sim job runs through the shared pool
    under the inline run's key, to the inline run's topology."""
    from repro_torch.core.engine.store import TopologyStore
    from repro_torch.serve.jobs import JobEngine

    params = {"backend": "sim", "device": "h100", "seed": 3, "n_samples": 9}
    engine = JobEngine(TopologyStore(str(tmp_path / "store")), workers=1,
                       parallel=PCFG).start()
    try:
        job, _ = engine.submit(params)
        engine.wait(job.job_id, timeout_s=120)
    finally:
        engine.stop()
    assert job.state == "done", job.error
    assert get_global_pool(PCFG).calls > 0
    inline_store = TopologyStore(str(tmp_path / "inline"))
    inline = JobEngine(inline_store, workers=1).start()
    try:
        ijob, _ = inline.submit(params)
        inline.wait(ijob.job_id, timeout_s=120)
    finally:
        inline.stop()
    assert ijob.key == job.key
    assert (_without_notes(engine.store.get(job.key).topology)
            == _without_notes(inline_store.get(ijob.key).topology))


def test_worker_modules_import_neither_torch_nor_jax():
    """What a pool worker imports to rebuild and run a sim or chaos runner
    from its spec leaves ``torch``, ``jax`` and the reference package out
    of ``sys.modules``."""
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {SRC!r})\n"
        "import repro_torch.core.engine.parallel as parallel\n"
        "import repro_torch.core.probes.chaos as chaos\n"
        "import repro_torch.core.probes.runners as runners\n"
        "from repro_torch.core.simulate import make_h100_like\n"
        "base = runners.SimRunner(make_h100_like(seed=3))\n"
        "spec = chaos.ChaosRunner(base, chaos.FaultSchedule(seed=1))"
        ".runner_spec()\n"
        "runner = pickle.loads(pickle.dumps(spec)).build()\n"
        "runner.pchase_many([('L1', 16384, 32)], 5)\n"
        "print(sorted(m for m in ('torch', 'jax', 'repro')"
        " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == "[]", out.stderr


def test_host_worker_imports_neither_torch_nor_jax():
    """A worker that rebuilds a ``HostRunner`` through
    ``build_host_runner`` and chases (the compiled chase loaded by
    ``ctypes``) leaves ``torch``, ``jax`` and the reference package out of
    ``sys.modules``."""
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {SRC!r})\n"
        "import repro_torch.core.probes.runners as runners\n"
        "spec = runners.HostRunner(max_bytes=1 << 23, iters=1 << 10,"
        " seed=4).runner_spec()\n"
        "for runner in (runners.build_host_runner(1 << 23, 1 << 10, 4),"
        " pickle.loads(pickle.dumps(spec)).build()):\n"
        "    assert type(runner) is runners.HostRunner\n"
        "    assert (runner.max_bytes, runner.iters, runner.seed)"
        " == (1 << 23, 1 << 10, 4)\n"
        "rows = runner.pchase_many([('host-cache', 16384, 64)], 3)\n"
        "assert rows.shape == (1, 3) and (rows > 0).all()\n"
        "print(sorted(m for m in ('torch', 'jax', 'repro')"
        " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == "[]", out.stderr


def test_planned_request_pools_and_checkpoints(tmp_path, global_pools):
    """A request with its own work-item ``plan`` runs its items over the
    pooled, cached runner, checkpoints after each item under a resilience
    policy, and persists: the same rows as the inline runner, the spent
    checkpoint cleared."""
    from repro_torch.core.engine.scheduler import WorkItem
    from repro_torch.core.engine.store import TopologyStore, request_key
    from repro_torch.core.topology import Topology

    dev = make_h100_like(seed=3)
    reqs = [("L1", 16 * KIB + 4 * KIB * i, 32) for i in range(6)]
    store = TopologyStore(str(tmp_path / "store"))
    seen = {}

    def plan(runner):
        return [WorkItem(key="rows", family="size",
                         fn=lambda _r: runner.pchase_many(reqs, 5)),
                WorkItem(key="again", family="size", deps=("rows",),
                         fn=lambda _r: runner.pchase_many(reqs[:3], 5))]

    def assemble(sched, timings):
        seen.update(sched.results)
        seen["checkpoint"] = store.load_checkpoint(key)
        return Topology(vendor=dev.vendor, model=dev.name, backend="plan")

    request = DiscoveryRequest(
        descriptor={"kind": "plan-test", "seed": dev.seed}, vendor=dev.vendor,
        model=dev.name, backend="plan", make_runner=lambda: SimRunner(dev),
        max_workers=0, resilience=Resilience(sleep=lambda _s: None),
        parallel=PCFG, plan=plan, assemble=assemble)
    key = request_key(request.descriptor)
    _, timings = discover(request, store=store)
    want = SimRunner(make_h100_like(seed=3)).pchase_many(reqs, 5)
    assert np.array_equal(np.asarray(seen["rows"]), want)
    assert np.array_equal(np.asarray(seen["again"]), want[:3])
    assert get_global_pool(PCFG).calls == 1          # the repeat was cached
    assert timings.meta["cache"]["misses"] == len(reqs)
    entries, done = seen["checkpoint"]
    assert done == ["rows", "again"] and len(entries) == len(reqs)
    assert not store.has_checkpoint(key) and store.get(key) is not None
