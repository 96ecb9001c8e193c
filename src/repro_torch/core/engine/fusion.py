"""Cross-family batch fusion: coalesce ready work items into one dispatch.

The scheduler already tracks which (space × family) work items are ready;
this module extends that into *round-based fusion*: every ready item runs
in its own worker thread against a transparent runner proxy, and each
runner call **parks** the thread instead of dispatching immediately.  When
every in-flight item is either finished or parked, the coordinator fuses
all parked requests that share a runner capability — warm chases onto one
``pchase_many``, cold passes onto one ``cold_chase_many``, eviction-pattern
probes onto one ``eviction_many`` grid — and executes
each fused group as a single dispatch on the coordinator thread, then wakes
the parked items with their slices.

Consequences:

* a refinement round costs ONE kernel launch for *all* concurrently
  active probe families instead of one per family — on the Pallas backend
  this is what collapses the per-discovery kernel-call count;
* actual kernel execution stays strictly serial (only the coordinator
  dispatches), so co-running probes never perturb each other's wall
  clocks — the property ``discover_pallas`` previously bought with an
  inline schedule;
* probe workflows are unchanged: the proxy exposes the ordinary
  ``ProbeRunner`` surface, and request-keyed runners return bit-identical
  samples no matter how calls are grouped.

Eviction-pattern probes (amount §IV-F, sharing §IV-G, cu-sharing §IV-H)
fuse too: they park as heterogeneous ``("evict", n_samples)`` rows and every
round coalesces them onto ONE ``eviction_many`` grid dispatch, mixing the
three families freely (the runners' eviction-grid capability keeps row i
bit-identical to the matching single-probe call).  Only bandwidth remains a
serial ``("exec",)`` call — it reports one scalar from its own stream-kernel
timing loop, so there is no row batching to coalesce — and it still executes
per-request inside the round, preserving the serial-execution guarantee.
Per-family timings include parked time and therefore overlap — they remain
useful as *shares*, not absolute wall seconds.

Each item's thread runs under its family's ``CURRENT_FAMILY`` (as the
unfused scheduler sets it), every parked call records that family, and
each fused dispatch runs under the sorted, ``+``-joined families of the
rows it carries, so a runner that files what it times by family (the CUDA
runner's calibration log) sees ``"latency+size"`` for a round that fused
those two families' rows instead of ``""``.  Samples do not change.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..errors import TransientRunnerError
from ..probes.runners import CURRENT_FAMILY

__all__ = ["FusionDispatcher", "run_fused"]


@dataclass
class _Pending:
    """One parked runner call awaiting the next fusion round."""

    group: tuple          # ("pchase", n) | ("cold", n) | ("evict", n) | ("exec",)
    rows: list = field(default_factory=list)   # fused-capability row requests
    thunk: Callable | None = None    # non-fusable: run against the runner
    family: str = ""                 # the parking item's CURRENT_FAMILY
    result: object = None
    error: BaseException | None = None
    event: threading.Event = field(default_factory=threading.Event)


class _FusionRunner:
    """ProbeRunner facade that parks every probe call on the dispatcher.

    Hook-style accessors (``spaces``, ``api_size``, ``cu_ids``,
    ``cores_per_sm``) pass straight through — they read metadata, not
    kernels — everything that measures goes through ``_park``.
    """

    def __init__(self, dispatcher: "FusionDispatcher"):
        self._d = dispatcher
        self._base = dispatcher.runner
        # planner prefetch capability mirrors the wrapped runner's caching
        self.caches_requests = getattr(self._base, "caches_requests", False)

    # ------------------------------------------------------ fused: warm
    def pchase(self, space, array_bytes, stride, n_samples):
        rows = self._d.park(("pchase", int(n_samples)),
                            [(space, int(array_bytes), int(stride))])
        return rows[0]

    def pchase_batch(self, space, array_bytes_list, stride, n_samples):
        reqs = [(space, int(ab), int(stride)) for ab in array_bytes_list]
        return np.stack(self._d.park(("pchase", int(n_samples)), reqs))

    def pchase_many(self, requests, n_samples, fresh: bool = False):
        reqs = [(space, int(ab), int(s)) for space, ab, s in requests]
        group = ("pchase-fresh" if fresh else "pchase", int(n_samples))
        return np.stack(self._d.park(group, reqs))

    # ------------------------------------------------------ fused: cold
    def cold_chase(self, space, array_bytes, stride, n_samples):
        rows = self._d.park(("cold", int(n_samples)),
                            [(space, int(array_bytes), int(stride))])
        return rows[0]

    def cold_chase_batch(self, space, array_bytes_list, stride_list,
                         n_samples):
        reqs = [(space, int(ab), int(s))
                for ab, s in zip(array_bytes_list, stride_list)]
        return np.stack(self._d.park(("cold", int(n_samples)), reqs))

    def cold_chase_many(self, requests, n_samples):
        reqs = [(space, int(ab), int(s)) for space, ab, s in requests]
        return np.stack(self._d.park(("cold", int(n_samples)), reqs))

    # ------------------------------------------------ fused: eviction grid
    # Mixed amount/sharing/cu rows share one ("evict", n) group per round
    # and dispatch as a single eviction_many grid call (§IV-F/G/H).
    def amount_probe(self, space, core_a, core_b, array_bytes, n_samples):
        rows = self._d.park(("evict", int(n_samples)),
                            [("amount", space, int(core_a), int(core_b),
                              int(array_bytes))])
        return rows[0]

    def sharing_probe(self, space_a, space_b, array_bytes, n_samples):
        rows = self._d.park(("evict", int(n_samples)),
                            [("sharing", space_a, space_b,
                              int(array_bytes))])
        return rows[0]

    def cu_sharing_probe(self, cu_a, cu_b, array_bytes, n_samples,
                         space="sL1d"):
        rows = self._d.park(("evict", int(n_samples)),
                            [("cu", space, int(cu_a), int(cu_b),
                              int(array_bytes))])
        return rows[0]

    def cu_sharing_probe_batch(self, cu_a, cu_bs, array_bytes, n_samples,
                               space="sL1d"):
        reqs = [("cu", space, int(cu_a), int(cu_b), int(array_bytes))
                for cu_b in cu_bs]
        return np.stack(self._d.park(("evict", int(n_samples)), reqs))

    def eviction_many(self, requests, n_samples):
        reqs = [tuple(r) for r in requests]
        return np.stack(self._d.park(("evict", int(n_samples)), reqs))

    # ------------------------------------------ serialized, non-fused calls
    # Bandwidth reports one scalar from its own stream-kernel loop — no row
    # batching exists to coalesce, so it runs per-request inside the round.
    def bandwidth(self, space, mode="read"):
        return self._d.park_exec(lambda r: r.bandwidth(space, mode))

    # ------------------------------------------------------------ hooks
    def spaces(self):
        return self._base.spaces()

    def api_size(self, space):
        return self._base.api_size(space)

    def cu_ids(self):
        return self._base.cu_ids()

    @property
    def cores_per_sm(self):
        return self._base.cores_per_sm

    @property
    def deterministic(self) -> bool:
        return getattr(self._base, "deterministic", False)


class FusionDispatcher:
    """Round coordinator: park, coalesce, dispatch, wake.

    ``runner`` is the engine's ``CachingRunner`` — fused groups land on its
    ``pchase_many``/``cold_chase_many``/``eviction_many``, so cached rows
    are served and duplicate rows across families cost one probe.
    """

    def __init__(self, runner):
        self.runner = runner
        self._cv = threading.Condition()
        self._active = 0                 # threads running (not parked/done)
        self._pending: list[_Pending] = []
        self._aborted = False
        self.rounds = 0                  # fusion rounds dispatched
        self.fused_calls = 0             # fused-capability dispatches issued
        self.fused_rows = 0              # rows those dispatches carried
        self.split_rounds = 0            # fused dispatches split after a fault

    def proxy(self) -> _FusionRunner:
        """A runner facade whose batch calls park on this dispatcher."""
        return _FusionRunner(self)

    # ----------------------------------------------------- thread-side API
    def thread_starting(self) -> None:
        """Register one item thread as in flight (coordinator waits on 0)."""
        with self._cv:
            self._active += 1

    def thread_finished(self) -> None:
        """Deregister an item thread; wakes a quiescence-waiting coordinator."""
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def park(self, group: tuple, rows: list) -> list:
        """Park the calling thread's probe rows under a fusion group key and
        block until the coordinator dispatches the fused round; returns this
        caller's slice of the fused result."""
        p = _Pending(group=group, rows=rows, family=CURRENT_FAMILY.get())
        self._park(p)
        return p.result

    def park_exec(self, thunk: Callable):
        """Park an arbitrary thunk for serial execution on the coordinator
        thread (the escape hatch for calls with no fused capability)."""
        p = _Pending(group=("exec",), thunk=thunk,
                     family=CURRENT_FAMILY.get())
        self._park(p)
        return p.result

    def _park(self, p: _Pending) -> None:
        with self._cv:
            if self._aborted:
                raise RuntimeError("fusion dispatcher aborted")
            self._pending.append(p)
            self._active -= 1
            self._cv.notify_all()
        p.event.wait()
        # NOTE: the coordinator re-activated this thread (active += 1) in
        # dispatch_round()/abort() *before* setting the event, so waking
        # must not increment again.
        if p.error is not None:
            raise p.error

    # ------------------------------------------------- coordinator-side API
    def wait_quiescent(self) -> None:
        """Block until every in-flight item thread is parked or finished."""
        with self._cv:
            while self._active > 0:
                self._cv.wait()

    def has_pending(self) -> bool:
        """True while parked rows await a fused dispatch round."""
        with self._cv:
            return bool(self._pending)

    def dispatch_round(self) -> None:
        """Execute one fused round on the calling (coordinator) thread."""
        with self._cv:
            batch, self._pending = self._pending, []
            self._active += len(batch)   # re-activate before waking
        self.rounds += 1
        groups: dict[tuple, list[_Pending]] = {}
        for p in batch:
            groups.setdefault(p.group, []).append(p)
        for key in sorted(groups, key=repr):
            ps = groups[key]
            if key[0] == "exec":
                for p in ps:
                    token = CURRENT_FAMILY.set(p.family)
                    try:
                        p.result = p.thunk(self.runner)
                    except BaseException as e:  # noqa: BLE001 — delivered
                        p.error = e
                    finally:
                        CURRENT_FAMILY.reset(token)
                continue
            token = CURRENT_FAMILY.set(
                "+".join(sorted({p.family for p in ps})))
            try:
                self._dispatch_group(key, ps)
            finally:
                CURRENT_FAMILY.reset(token)
        for p in batch:
            p.event.set()

    def _dispatch_group(self, key: tuple, ps: list) -> None:
        """One fused dispatch of a group's parked rows, each pending given
        its slice (or the error that befell it)."""
        all_rows = [r for p in ps for r in p.rows]
        try:
            if key[0] == "pchase-fresh":
                rows = np.asarray(self.runner.pchase_many(
                    all_rows, key[1], fresh=True))
            elif key[0] == "evict":
                rows = np.asarray(self.runner.eviction_many(
                    all_rows, key[1]))
            else:
                fn = (self.runner.pchase_many if key[0] == "pchase"
                      else self.runner.cold_chase_many)
                rows = np.asarray(fn(all_rows, key[1]))
            self.fused_calls += 1
            self.fused_rows += len(all_rows)
            at = 0
            for p in ps:
                p.result = [rows[at + j] for j in range(len(p.rows))]
                at += len(p.rows)
        except TransientRunnerError:
            # A fault inside a fused dispatch must not fail every item
            # that happened to share the round: split the group into
            # per-row single calls so only genuinely failing rows
            # poison their pending (already-fetched rows are served by
            # the caching runner at zero cost).
            self.split_rounds += 1
            for p in ps:
                try:
                    p.result = [self._single_row(key, r) for r in p.rows]
                except BaseException as e:  # noqa: BLE001 — delivered
                    p.error = e
        except BaseException as e:  # noqa: BLE001 — delivered per item
            for p in ps:
                p.error = e

    def _single_row(self, group: tuple, row: tuple):
        """Serve one fused-group row via its single-probe equivalent (the
        split-and-retry fallback after a fused dispatch faulted)."""
        kind, n = group[0], group[1]
        if kind == "pchase":
            space, ab, stride = row
            return np.asarray(self.runner.pchase(space, ab, stride, n))
        if kind == "pchase-fresh":
            return np.asarray(self.runner.pchase_many([row], n,
                                                      fresh=True))[0]
        if kind == "cold":
            space, ab, stride = row
            return np.asarray(self.runner.cold_chase(space, ab, stride, n))
        tag = row[0]                     # evict rows carry their own kind
        if tag == "amount":
            _, space, a, b, ab = row
            return np.asarray(self.runner.amount_probe(space, a, b, ab, n))
        if tag == "sharing":
            _, sa, sb, ab = row
            return np.asarray(self.runner.sharing_probe(sa, sb, ab, n))
        _, space, a, b, ab = row
        return np.asarray(self.runner.cu_sharing_probe(a, b, ab, n,
                                                       space=space))

    def abort(self, exc: BaseException) -> None:
        """Release every parked thread with ``exc`` (error teardown)."""
        with self._cv:
            self._aborted = True
            batch, self._pending = self._pending, []
            self._active += len(batch)
        for p in batch:
            p.error = exc
            p.event.set()


def run_fused(items, dispatcher: FusionDispatcher, *, timings=None,
              resilience=None, on_exhausted=None, on_item_done=None):
    """Execute work items with round-based fusion (see module docstring).

    Dependency semantics match ``run_work_items``: an item starts once its
    deps completed; newly released items join the *current* round before it
    dispatches, so their first probes fuse with everyone else's.

    Fault tolerance mirrors the unfused scheduler: with a ``resilience``
    policy, an item that failed on a ``TransientRunnerError`` is restarted
    (up to ``max_retries`` times, capped backoff) — its already-fetched
    rows replay from the caching runner, so a retry only re-probes what
    actually failed — and past the budget it degrades through
    ``on_exhausted`` instead of aborting the whole fused run.
    """
    from .scheduler import ScheduleResult, check_items

    by_key = check_items(items)
    out = ScheduleResult()
    t_start = time.perf_counter()
    pending = dict(by_key)
    lock = threading.Lock()
    finished: list[tuple] = []
    threads: dict = {}
    attempts: dict = {}                  # item key -> transient retries spent

    def ready(it) -> bool:
        return all(d in out.results for d in it.deps)

    def start(it) -> None:
        def body():
            CURRENT_FAMILY.set(it.family)   # this thread's own context
            t0 = time.perf_counter()
            value = err = None
            try:
                value = it.fn(out.results)
            except BaseException as e:  # noqa: BLE001 — re-raised by the loop
                err = e
            dt = time.perf_counter() - t0
            with lock:
                finished.append((it, value, err, dt))
            dispatcher.thread_finished()

        dispatcher.thread_starting()
        th = threading.Thread(target=body, daemon=True,
                              name=f"probe-{it.key}")
        threads[it.key] = th
        th.start()

    for it in [i for i in list(pending.values()) if ready(i)]:
        del pending[it.key]
        start(it)

    while threads or pending:
        dispatcher.wait_quiescent()
        with lock:
            done, finished[:] = finished[:], []
        for it, value, err, dt in done:
            threads.pop(it.key).join()
            if err is not None:
                transient = (resilience is not None
                             and isinstance(err, TransientRunnerError))
                spent = attempts.get(it.key, 0)
                if transient and spent < resilience.max_retries:
                    resilience.sleep(resilience.backoff(spent))
                    attempts[it.key] = spent + 1
                    out.retries += 1
                    start(it)            # restart; cached rows replay free
                    continue
                if (transient and resilience.degrade
                        and on_exhausted is not None):
                    out.degraded.append(it.key)
                    out.results[it.key] = on_exhausted(it, err, spent + 1)
                    out.order.append(it.key)
                    if on_item_done is not None:
                        on_item_done(it.key)
                    continue
                dispatcher.abort(RuntimeError(
                    f"work item {it.key!r} failed; fusion round aborted"))
                raise err
            out.results[it.key] = value
            out.order.append(it.key)
            if timings is not None and it.family:
                timings.add(it.family, dt)
            if on_item_done is not None:
                on_item_done(it.key)
        newly = [i for i in list(pending.values()) if ready(i)]
        for it in newly:
            del pending[it.key]
            start(it)
        if newly:
            continue                     # let them park into this round
        if dispatcher.has_pending():
            dispatcher.dispatch_round()
        elif threads:
            if not done:
                raise RuntimeError(
                    "fusion stall: running items neither finished nor parked")
        elif pending:
            raise ValueError("dependency cycle among work items: "
                             f"{sorted(map(str, pending))}")

    out.wall_seconds = time.perf_counter() - t_start
    return out
