"""Adaptive coarse-to-fine sweep planner (the probe-volume optimizer).

MT4G's reliability comes from statistical change-point detection over
microbenchmark sweeps, but a *dense* sweep measures every grid point even
though the K-S statistics localize the boundary after a handful of rows.
This module plans sweeps instead of enumerating them:

* a **coarse logarithmic pass** (the §IV-B doubling ladder, issued in
  chunked batch calls) brackets the boundary octave;
* the dense workflow's own **binary bisection** narrows the interval —
  replayed probe-for-probe so the planner lands on the *identical sweep
  lattice* as the dense path;
* a **deterministic classification descent** (``descend_first_shifted``)
  walks O(log n) rows of that lattice to pin the discrete boundary, and a
  small window around the flip feeds the K-S confidence metric.

Identity contract: the dense sweeps (``budget=None``) remain the
equivalence oracle.  Discrete attributes — sizes, line size, fetch
granularity, amounts, sharing — are *identical* planner-vs-dense because
both paths evaluate the same local boundary rule over the same grid rows
(request-keyed streams on simulated runners; shared caches otherwise), and
every planned search **falls back to the dense sweep** whenever its local
monotonicity assumptions fail (non-monotone classifications, flukes near
the boundary, budget exhaustion).  Only the non-discrete floats
(confidence, p-value) may differ, computed from a window instead of the
full series.

Two mechanisms keep planned searches cheap in *rounds*, not just rows:

* **speculative quantile prefetch** — before replaying a bisection or
  descent, the planner fetches the next few generations of integer
  midpoints the search may visit as ONE fused dispatch
  (``pchase_many``/``cold_chase_batch``/``eviction_many``), pre-filling
  the engine's sample cache under the decision procedure's own request
  keys.  The unchanged procedure then replays over cache hits, so a
  sequential O(log n) round chain collapses to one or two fused rounds
  while the lattice, the predicates, and (on request-keyed runners) the
  row values stay exactly those of the sequential path;
* **pairwise lattice planning** — the §IV-F amount ladder bisects for the
  first non-evicting core doubling, and the §IV-G/§IV-H sharing lattices
  probe hypothesis-first (partition closure for space pairs, closed-pair
  spot checks for CU pairs), with every accepted shortcut verified by
  independent rows and any disagreement falling back to the dense
  pairwise sweep.

``SweepBudget`` is the knob set carried on ``DiscoveryRequest``: round and
row ceilings plus an optional target resolution for deliberately coarse
(non-oracle-identical) scans; ``target_resolution`` also drives the fleet
survey mode's spot-check margins (see ``core.discover``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..probes.amount import (AmountResult, CuSharingResult, SharingResult,
                             _hit_miss_refs, amount_ladder, find_amount,
                             find_sharing_batch)
from ..probes.linesize import (GranularityResult, LineSizeResult,
                               find_fetch_granularity, find_line_size,
                               granularity_refs, line_size_from_first_hit)
from ..probes.size import (ShiftClassifier, SizeResult, bisect_interval,
                           boundary_window, classification_jump,
                           descend_first_shifted, finalize_size,
                           rescue_change_point, sweep_grid, sweep_rows,
                           widen_interval)
from ..stats import classify_miss_rows, geometric_reduction

__all__ = ["SweepBudget", "find_size_planned", "find_granularity_planned",
           "find_line_size_planned", "find_amount_planned",
           "find_sharing_planned", "find_cu_sharing_planned"]

KIB = 1024


@dataclass(frozen=True)
class SweepBudget:
    """Resource envelope for one planned family search.

    ``max_rounds`` bounds interval widenings plus ladder chunks, and
    ``max_rows`` is a ceiling on sampled grid rows per search — exhausting
    either falls back to the dense sweep, so a budget can make a search
    slower but never wrong.  ``target_resolution`` (bytes) coarsens the
    final lattice for deliberately cheap scans — the only knob that trades
    the dense-identity guarantee for speed, so it defaults to off.  (The
    boundary-detection window is deliberately NOT a knob:
    ``size.BOUNDARY_WINDOW`` is shared with the dense path because both
    must evaluate the identical window for their answers to be identical.)
    """

    max_rounds: int = 12
    max_rows: int | None = None
    target_resolution: int | None = None
    ladder_chunk: int = 4          # doubling-ladder batch size

    def descriptor(self) -> dict:
        """Stable content-address fragment for the TopologyStore."""
        return {
            "max_rounds": int(self.max_rounds),
            "max_rows": None if self.max_rows is None else int(self.max_rows),
            "target_resolution": (None if self.target_resolution is None
                                  else int(self.target_resolution)),
            "ladder_chunk": int(self.ladder_chunk),
        }


class _RowMeter:
    """Counts grid rows a planned search has fetched (max_rows accounting)."""

    def __init__(self, budget: SweepBudget):
        self.limit = budget.max_rows
        self.rows = 0

    def charge(self, n: int) -> None:
        self.rows += int(n)

    @property
    def exhausted(self) -> bool:
        return self.limit is not None and self.rows >= self.limit


def _fetch_window(runner, space: str, sizes: np.ndarray, step: int,
                  n_samples: int) -> np.ndarray:
    """Fetch a row window as ONE fresh dispatch when the runner supports it.

    The window change-point scan compares rows against each other, so on
    measuring runners they must share a launch clock; ``fresh=True``
    bypasses cache *serving* (identical values on request-keyed runners).
    """
    try:
        return np.asarray(runner.pchase_many(
            [(space, int(s), int(step)) for s in sizes], n_samples,
            fresh=True))
    except (AttributeError, TypeError):
        return sweep_rows(runner, space, sizes, step, n_samples,
                          batched=True)


def _bisect_midpoints(lo: int, hi: int, levels: int,
                      stop_span=None) -> list[int]:
    """The next ``levels`` generations of integer midpoints a binary search
    over ``(lo, hi)`` may visit.

    Enumerates BOTH child intervals of every midpoint — the search visits
    exactly one path, so roughly half the points are speculative.
    ``stop_span(a, b)`` prunes branches the search would already have
    terminated.  The midpoint rule ``(a + b) // 2`` is shared with
    ``bisect_interval`` and ``descend_first_shifted``, so prefetched points
    land on exactly the rows the replay asks for.
    """
    pts: list[int] = []
    frontier = [(int(lo), int(hi))]
    for _ in range(max(int(levels), 0)):
        nxt: list[tuple[int, int]] = []
        for a, b in frontier:
            if b - a <= 1 or (stop_span is not None and stop_span(a, b)):
                continue
            mid = (a + b) // 2
            pts.append(mid)
            nxt.append((a, mid))
            nxt.append((mid, b))
        frontier = nxt
    return pts


def _prefetch_pchase(runner, space: str, reqs, n_samples: int,
                     meter: "_RowMeter | None" = None) -> None:
    """Speculative prefetch: fill the sample cache with the warm-chase rows
    a bisection/descent is most likely to ask for, in ONE fused dispatch.

    ``reqs`` is a list of ``(array_bytes, stride)`` pairs.  The decision
    procedure then replays unchanged over cache hits — prefetching is
    result-invisible on request-keyed/cached runners and only converts a
    sequential round chain into one fused round.  Prefetched rows are
    charged to the meter when given (conservative: a speculative row the
    replay never consumes still counts toward ``max_rows``).  Runners
    without the ``caches_requests`` capability would pay a real probe for
    every speculative row AND the replay row — skip them entirely.
    """
    if not getattr(runner, "caches_requests", False):
        return
    uniq = sorted({(int(ab), int(s)) for ab, s in reqs})
    if not uniq:
        return
    try:
        runner.pchase_many([(space, ab, s) for ab, s in uniq], n_samples)
    except (AttributeError, TypeError, NotImplementedError):
        return
    if meter is not None:
        meter.charge(len(uniq))


def _prefetch_cold(runner, space: str, arrs, strides, n_loads: int,
                   meter: "_RowMeter | None" = None) -> None:
    """Cold-capability twin of ``_prefetch_pchase`` (one fused dispatch
    pre-filling the §IV-D probe's own ``cold_chase_batch`` row keys)."""
    if not arrs or not getattr(runner, "caches_requests", False):
        return
    try:
        runner.cold_chase_batch(space, list(arrs), list(strides), n_loads)
    except (AttributeError, NotImplementedError):
        return
    if meter is not None:
        meter.charge(len(arrs))


# --------------------------------------------------------------------------
# §IV-B size search
# --------------------------------------------------------------------------
def find_size_planned(runner, space: str, *, budget: SweepBudget,
                      lo: int = 1 * KIB, step: int = 32, n_samples: int = 33,
                      alpha: float = 0.01, max_points: int = 96,
                      max_widenings: int = 3,
                      max_bytes: int | None = None) -> SizeResult:
    """Coarse-to-fine §IV-B search; discrete-identical to dense ``find_size``.

    Stage 1 (coarse): the doubling ladder is issued in ``ladder_chunk``-row
    batch calls instead of one probe per doubling — same first-shifted
    decision, a fraction of the dispatches.  Stage 2: the dense bisection,
    replayed exactly.  Stage 3 (fine): the classification descent over the
    dense sweep lattice samples O(log n) rows where the dense path measures
    all of them; a ±``window`` row neighborhood of the flip is then fetched
    (one batch call, mostly cache hits) for the K-S confidence split.
    """
    from ..probes.size import find_size          # dense fallback

    max_bytes = max_bytes or 64 * 1024 * KIB
    meter = _RowMeter(budget)
    rounds = 0

    # -- coarse pass: chunked doubling ladder.  On caching runners the
    # base row and the WHOLE ladder go out as one fused dispatch up front —
    # a probe batch costs one launch regardless of row count, so this beats
    # paying a launch per chunk even though rungs past the boundary are
    # speculative; the chunked loop below replays over cache hits and keeps
    # the identical early-exit decision sequence.
    ladder = []
    size = lo
    while size <= max_bytes:
        size *= 2
        ladder.append(size)
    _prefetch_pchase(runner, space,
                     [(lo, step)] + [(sz, step) for sz in ladder],
                     n_samples, meter)

    base = runner.pchase(space, lo, step, n_samples)
    clf = ShiftClassifier(base, alpha, classification_jump(runner))
    meter.charge(1)

    first_bad = None
    probed = 0
    for c in range(0, len(ladder), max(budget.ladder_chunk, 1)):
        part = ladder[c: c + max(budget.ladder_chunk, 1)]
        rows = sweep_rows(runner, space, part, step, n_samples, batched=True)
        meter.charge(len(part))
        probed += len(part)
        rounds += 1
        for sz, row in zip(part, rows):
            if clf.shifted(row):
                first_bad = sz
                break
        if first_bad is not None or rounds >= budget.max_rounds:
            break
    if first_bad is None:
        if probed < len(ladder):
            # ladder cut short by the round budget: let the oracle decide
            return find_size(runner, space, lo=lo, step=step,
                             n_samples=n_samples, alpha=alpha,
                             max_points=max_points,
                             max_widenings=max_widenings,
                             max_bytes=max_bytes, batched=True)
        # No shifted rung: re-fetch the ladder as ONE fresh launch and look
        # for an inter-rung regime change (baseline-free — the dense path's
        # ladder_rescue over the same keyed rows on simulated runners).
        from ..probes.size import ladder_rescue

        fresh = _fetch_window(runner, space, np.asarray(ladder), step,
                              n_samples)
        meter.charge(len(ladder))
        first_bad = ladder_rescue(ladder, fresh, alpha)
    if first_bad is None:
        return SizeResult(-1, False, 0.0, 1.0, np.zeros(0), np.zeros(0),
                          0, n_samples)

    # -- bisection: identical to the dense path, probe for probe (single
    # rows go through the lean ``pchase`` cache path, not a 1-row batch)
    def shifted_at(sz: int) -> bool:
        meter.charge(1)
        return clf.shifted(runner.pchase(space, int(sz), step, n_samples))

    # Speculative quantile prefetch: the first three midpoint generations
    # of the bisection (pruned by its own termination rule) in ONE fused
    # dispatch; ``bisect_interval`` below replays over cache hits.
    def _bisect_done(a: int, b: int) -> bool:
        return b - a <= max(8 * step, (a + b) // 64)

    _prefetch_pchase(
        runner, space,
        [(sz, step) for sz in _bisect_midpoints(first_bad // 2, first_bad, 5,
                                                stop_span=_bisect_done)],
        n_samples, meter)
    sweep_lo, sweep_hi = bisect_interval(shifted_at, first_bad, step)

    eff_floor = step
    if budget.target_resolution is not None:
        eff_floor = max(step, budget.target_resolution // step * step)

    widenings = 0
    while True:
        G, eff_step = sweep_grid(sweep_lo, sweep_hi, step, max_points)
        if eff_floor > eff_step:
            # Deliberately coarse scan (non-oracle-identical, documented).
            # The bisected interval can be narrower than a few coarse
            # steps, so pad it — the descent needs a bracketable grid.
            pad = 4 * eff_floor
            glo, ghi = max(lo, sweep_lo - pad), min(max_bytes, sweep_hi + pad)
            G = np.arange(glo, ghi + eff_floor, eff_floor, dtype=np.int64)
            eff_step = eff_floor
        n = G.size
        if n < 4 or meter.exhausted:
            # unusably small lattice / row budget exhausted: the dense
            # sweep is slower but never wrong
            return find_size(runner, space, lo=lo, step=step,
                             n_samples=n_samples, alpha=alpha,
                             max_points=max_points,
                             max_widenings=max_widenings,
                             max_bytes=max_bytes, batched=True)

        memo: dict[int, np.ndarray] = {}

        def row_at(i: int) -> np.ndarray:
            if i not in memo:
                memo[i] = runner.pchase(space, int(G[i]), step, n_samples)
                meter.charge(1)
            return memo[i]

        # Descent prefetch: the top anchor plus four midpoint generations
        # of the index bisection (lo_known starts at -1), one fused
        # dispatch; ``descend_first_shifted`` replays over cache hits and
        # only its confirm rows near the landing fetch individually.
        spec = [n - 1] + _bisect_midpoints(-1, n - 1, 5)
        _prefetch_pchase(runner, space,
                         [(int(G[i]), step) for i in spec if 0 <= i < n],
                         n_samples, meter)
        flip = descend_first_shifted(lambda i: clf.shifted(row_at(i)), n)

        if (flip <= 2 or flip >= n - 2) and widenings < max_widenings:
            rounds += 1
            if rounds >= budget.max_rounds:
                return find_size(runner, space, lo=lo, step=step,
                                 n_samples=n_samples, alpha=alpha,
                                 max_points=max_points,
                                 max_widenings=max_widenings,
                                 max_bytes=max_bytes, batched=True)
            widenings += 1
            sweep_lo, sweep_hi = widen_interval(sweep_lo, sweep_hi, eff_step,
                                                lo, max_bytes)
            continue
        if 0 < flip < n:
            # The boundary window: the same fixed-width slice of the
            # lattice the dense path evaluates, fetched FRESH as one
            # dispatch — the window scan needs rows that share a launch
            # clock, not a mix of descent-time cache entries recorded at
            # different drift levels (request-keyed runners return
            # identical rows either way).
            wa, wb = boundary_window(flip, n)
            wrows = _fetch_window(runner, space, G[wa:wb], step, n_samples)
            meter.charge(wb - wa)
            result = finalize_size(G, wa, wrows, flip, widenings, n_samples,
                                   alpha)
        else:
            result = None
        if result is None:
            # Flip escaped/suspect: fetch the whole lattice (ONE fresh
            # launch — its rows share a scale) and run the same
            # scale-immune change-point rescue as the dense sweep.
            rows = _fetch_window(runner, space, G, step, n_samples)
            meter.charge(n)
            result = rescue_change_point(G, rows, widenings, n_samples,
                                         alpha)
        if not result.found and widenings < max_widenings:
            # same power-recovery widening as the dense sweep
            rounds += 1
            if rounds >= budget.max_rounds:
                return find_size(runner, space, lo=lo, step=step,
                                 n_samples=n_samples, alpha=alpha,
                                 max_points=max_points,
                                 max_widenings=max_widenings,
                                 max_bytes=max_bytes, batched=True)
            widenings += 1
            sweep_lo, sweep_hi = widen_interval(sweep_lo, sweep_hi, eff_step,
                                                lo, max_bytes)
            continue
        return result


# --------------------------------------------------------------------------
# §IV-D fetch-granularity search
# --------------------------------------------------------------------------
def find_granularity_planned(runner, space: str, *, budget: SweepBudget,
                             max_stride: int = 512,
                             array_bytes: int = 64 * 1024,
                             n_samples: int = 65, stride_step: int = 4,
                             confirm: int = 2) -> GranularityResult:
    """Bisection for the first all-miss stride + local run verification.

    The dense answer is the start of the first ``confirm + 1``-long run of
    all-miss strides; that is a local predicate of the stride grid, so a
    bisection that assumes "mixed below G, all-miss above" finds it in
    O(log n) rows and then *verifies* the run locally.  Any verification
    failure (a fluke hit past the candidate, a mixed stride at the grid
    top, hits at the first stride without a leading run) means the
    monotonicity assumption does not hold — fall back to the dense sweep,
    which is fluke-robust by construction.
    """
    def dense() -> GranularityResult:
        return find_fetch_granularity(
            runner, space, max_stride=max_stride, array_bytes=array_bytes,
            n_samples=n_samples, stride_step=stride_step, confirm=confirm,
            batched=True)

    hit_ref, miss_ref, thresh, hit_med, miss_med = granularity_refs(
        runner, space, array_bytes, max_stride, n_samples, stride_step)
    del hit_ref, miss_ref
    strides = np.arange(stride_step, max_stride + stride_step, stride_step)
    if miss_med < hit_med * 1.5:
        # same degenerate-references refusal as the dense sweep
        return GranularityResult(-1, False, strides[:0],
                                 np.zeros(0, dtype=bool))
    n = strides.size
    n_loads = 16 * n_samples
    min_frac = max(0.005, 2.0 / n_loads)

    memo: dict[int, bool] = {}

    def mixed(i: int) -> bool:
        if i not in memo:
            s = int(strides[i])
            arr = max(array_bytes, s * (n_loads + 1))
            row = np.asarray(runner.cold_chase_batch(space, [arr], [s],
                                                     n_loads))[0] \
                if hasattr(runner, "cold_chase_batch") else \
                runner.cold_chase(space, arr, s, n_loads)
            memo[i] = float(np.mean(np.asarray(row) < thresh)) > min_frac
        return memo[i]

    def prefetch(idxs) -> None:
        """One fused cold dispatch pre-filling ``mixed``'s own row keys."""
        todo = sorted({i for i in idxs if 0 <= i < n and i not in memo})
        _prefetch_cold(
            runner, space,
            [max(array_bytes, int(strides[i]) * (n_loads + 1)) for i in todo],
            [int(strides[i]) for i in todo], n_loads)

    # Speculative prefetch: both anchors plus the first three midpoint
    # generations of the bisection in ONE fused cold dispatch — the
    # sequential probes below replay over cache hits, collapsing the
    # dominant ~log n cold rounds of this search.
    prefetch(list(range(n - 1 - confirm, n)) + [0, 1, 2]
             + _bisect_midpoints(0, n - 1 - confirm, 3))

    # top anchor: the largest strides must be cleanly all-miss
    if any(mixed(i) for i in range(n - 1 - confirm, n)):
        return dense()
    if not mixed(0):
        # granularity at (or flukes near) the very first stride
        upto = min(confirm + 1, n)
        if all(not mixed(i) for i in range(upto)):
            m = np.array([mixed(i) for i in range(upto)], dtype=bool)
            return GranularityResult(int(strides[0]), True, strides[:upto], m)
        return dense()

    # Wave bisection: every three halvings, prefetch the next three
    # midpoint generations of the CURRENT interval as one fused dispatch —
    # a probe batch costs one launch regardless of row count, so covering
    # both children of every midpoint is cheaper than one sequential miss.
    lo, hi = 0, n - 1 - confirm
    while hi - lo > 1:
        prefetch(_bisect_midpoints(lo, hi, 4))
        for _ in range(4):
            if hi - lo <= 1:
                break
            mid = (lo + hi) // 2
            if mixed(mid):
                lo = mid
            else:
                hi = mid
    f = hi
    # Fetch the verification runs below in one fused dispatch too.
    prefetch([f + k for k in range(confirm + 1)] + [f - 1, f - 2])
    # Run verification: confirm successors all-miss, predecessors mixed.
    # TWO predecessors, not one — the bisection's landing flag and the
    # f-1 verification would otherwise be the same (possibly fluked) row,
    # and on measuring backends a single drifted launch can scale a whole
    # row across the hit/miss threshold.  Demanding an independent second
    # mixed row squares the fluke probability; any disagreement falls
    # back to the fluke-robust dense sweep.
    if any(mixed(f + k) for k in range(confirm + 1)):
        return dense()
    if any(not mixed(f - k) for k in (1, 2) if f - k >= 0):
        return dense()
    upto = f + confirm + 1
    m = np.zeros(upto, dtype=bool)
    for i, flag in memo.items():
        if i < upto:
            m[i] = flag
    return GranularityResult(int(strides[f]), True, strides[:upto], m)


# --------------------------------------------------------------------------
# §IV-E line-size search
# --------------------------------------------------------------------------
def find_line_size_planned(runner, space: str, cache_size: int,
                           fetch_granularity: int, *, budget: SweepBudget,
                           n_samples: int = 65, over_factor: float = 1.0625,
                           max_line: int = 1024) -> LineSizeResult:
    """Bisection for the first hit-classified step (§IV-E).

    The dense answer is the first step whose distribution sits closer to
    the certain-hit reference than to the certain-miss pivot — again a
    local predicate, structurally monotone (footprint shrinks below
    capacity exactly once as the step grows).  Verified at the flip;
    non-monotone scores fall back to the dense chunked sweep.
    """
    def dense() -> LineSizeResult:
        return find_line_size(runner, space, cache_size, fetch_granularity,
                              n_samples=n_samples, over_factor=over_factor,
                              max_line=max_line, batched=True)

    from ..probes.linesize import hit_scores

    g2 = max(fetch_granularity // 2, 4)
    arr = int(cache_size * over_factor)
    steps = np.arange(g2, max_line * 2 + g2, g2, dtype=np.int64)
    n = steps.size

    # Speculative prefetch: both references, the anchor steps, and four
    # midpoint generations of the bisection as ONE fused dispatch — the
    # sequential ``score`` probes below replay over cache hits.
    spec = [0, 1, 2, n - 1, n - 2] + _bisect_midpoints(0, n - 1, 5)
    _prefetch_pchase(runner, space,
                     [(arr, g2), (arr, max_line * 8)]
                     + [(arr, int(steps[i])) for i in spec if 0 <= i < n],
                     n_samples)

    pivot = runner.pchase(space, arr, g2, n_samples)
    hit_ref = runner.pchase(space, arr, max_line * 8, n_samples)

    memo: dict[int, float] = {}

    def score(i: int) -> float:
        if i not in memo:
            row = runner.pchase(space, arr, int(steps[i]), n_samples)
            memo[i] = float(hit_scores(row, pivot, hit_ref)[0])
        return memo[i]

    if score(0) > 0:
        # line <= granularity/2: every step hits — but demand independent
        # confirmation before accepting the degenerate answer
        if any(score(k) <= 0 for k in (1, 2) if k < n):
            return dense()
        first_hit_step = int(steps[0])
    elif score(n - 1) <= 0:
        # top step misses: demand an independent second row before the
        # terminal not-found (a single drifted launch must not erase the
        # attribute); disagreement lets dense rule
        if n >= 2 and score(n - 2) > 0:
            return dense()
        return LineSizeResult(-1, False, -1.0, steps,
                              np.array([score(0), score(n - 1)]))
    else:
        # same wave-prefetched bisection as the granularity planner
        lo, hi = 0, n - 1
        while hi - lo > 1:
            _prefetch_pchase(
                runner, space,
                [(arr, int(steps[i]))
                 for i in _bisect_midpoints(lo, hi, 4) if i not in memo],
                n_samples)
            for _ in range(4):
                if hi - lo <= 1:
                    break
                mid = (lo + hi) // 2
                if score(mid) > 0:
                    hi = mid
                else:
                    lo = mid
        # Verify with an extra independent below-flip row (mirrors the
        # granularity planner): non-monotone scores let dense rule.
        _prefetch_pchase(runner, space,
                         [(arr, int(steps[hi - k])) for k in (1, 2)
                          if hi - k >= 0 and hi - k not in memo], n_samples)
        if any(score(hi - k) > 0 for k in (1, 2) if hi - k >= 0):
            return dense()
        first_hit_step = int(steps[hi])

    line, raw = line_size_from_first_hit(first_hit_step, over_factor, g2)
    ks = sorted(memo)
    return LineSizeResult(line, True, raw, steps[ks],
                          np.array([memo[i] for i in ks]))


# --------------------------------------------------------------------------
# §IV-F amount ladder
# --------------------------------------------------------------------------
def find_amount_planned(runner, space: str, cache_size: int,
                        cores_per_sm: int, *, n_samples: int = 65,
                        budget: SweepBudget) -> AmountResult:
    """Bisection over the §IV-F core-B doubling ladder (first NON-evicting
    rung) with memo-consistency verification.

    The dense sweep probes every doubling until core B stops evicting core
    A; under the paper's segment model the evicts-flag is monotone in the
    rung index (True below the boundary, False at and above it), so a
    bisection pins the flip in O(log n) eviction rows.  Every rung the
    planner *did* probe is then checked against the monotone pattern and
    the two rungs below the flip are verified independently — any
    disagreement falls back to the dense ladder, so the discrete answer
    (amount, first disjoint core) is identical planner-vs-dense.  Rows go
    out as fused ``eviction_many`` grid calls where the runner supports
    them (speculative midpoints prefetched with the anchors in ONE
    dispatch), one ``amount_probe`` per rung otherwise.
    """
    def dense() -> AmountResult:
        return find_amount(runner, space, cache_size, cores_per_sm,
                           n_samples=n_samples, batched=True)

    bs = amount_ladder(cores_per_sm)
    if not bs:
        return AmountResult(1, True, -1, [])
    arr = int(cache_size * 0.9)
    hit_ref, miss_ref = _hit_miss_refs(runner, space, arr, cache_size,
                                       n_samples)
    meter = _RowMeter(budget)
    n = len(bs)
    memo: dict[int, bool] = {}

    def fetch(idxs) -> None:
        """Probe-and-classify rungs in ONE fused eviction dispatch."""
        todo = sorted({int(i) for i in idxs if 0 <= i < n and i not in memo})
        if not todo:
            return
        if hasattr(runner, "eviction_many"):
            rows = np.asarray(runner.eviction_many(
                [("amount", space, 0, bs[i], arr) for i in todo], n_samples))
        else:
            rows = np.stack([runner.amount_probe(space, 0, bs[i], arr,
                                                 n_samples) for i in todo])
        meter.charge(len(todo))
        for i, m in zip(todo, classify_miss_rows(rows, hit_ref, miss_ref)):
            memo[i] = bool(m)

    def evicts(i: int) -> bool:
        if i not in memo:
            fetch([i])
        return memo[i]

    # anchors + the first two midpoint generations, one fused dispatch
    fetch([0, n - 1] + _bisect_midpoints(0, n - 1, 2))
    if meter.exhausted:
        return dense()
    if not evicts(0):
        # core B = 1 already leaves A resident: the dense sweep would stop
        # at the very first rung
        return AmountResult(max(cores_per_sm // bs[0], 1), True, bs[0],
                            [bs[0]])
    if evicts(n - 1):
        # no non-evicting rung in sight: complete the ladder (one fused
        # call for the few unprobed rungs) and demand it be uniformly
        # evicting — mirroring the dense sweep's full walk exactly
        fetch(range(n))
        if any(not memo[i] for i in memo):
            return dense()
        return AmountResult(1, True, -1, list(bs))

    lo, hi = 0, n - 1            # evicts(lo) is True, evicts(hi) is False
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if evicts(mid):
            lo = mid
        else:
            hi = mid
    f = hi
    # Two independent below-flip rungs must evict (same squared-fluke
    # argument as the granularity planner), and every memoized rung must
    # match the monotone pattern the bisection assumed.
    fetch([f - 1, f - 2])
    if any(not evicts(f - k) for k in (1, 2) if f - k >= 0):
        return dense()
    if any(memo[i] != (i < f) for i in memo):
        return dense()
    if meter.exhausted:
        return dense()
    tested = [bs[i] for i in sorted(memo) if i <= f]
    return AmountResult(max(cores_per_sm // bs[f], 1), True, bs[f], tested)


# --------------------------------------------------------------------------
# §IV-G sharing lattice
# --------------------------------------------------------------------------
def find_sharing_planned(runner, leaders, n_samples: int = 65, *,
                         budget: SweepBudget) -> list[SharingResult]:
    """Partition-closure planning for the §IV-G pairwise sharing lattice.

    ``leaders`` is the registry's ordered leader list — ``(space_a,
    cache_size, partners)`` triples covering every pair once.  Physical
    sharing is an equivalence relation (two spaces either occupy one cache
    or they don't), so once earlier leaders have probed a pair's relation
    to a common third space ``L`` with at least one positive edge, the
    pair's own flag is determined: ``a~p iff a~L and p~L``.  When EVERY
    partner of a leader is inferable this way, the planner spot-checks the
    first partner with a real probe row and accepts the inferred row on
    agreement; any disagreement — or any partner without a witnessing
    ``L`` — issues the dense ``find_sharing_batch`` row for that leader.

    Discrete identity: inferred flags equal dense flags whenever the
    equivalence hypothesis holds, and the hypothesis is spot-checked per
    leader; a violation (non-transitive measurements) is caught by the
    spot row or surfaces as an inference gap, both of which fall back to
    dense rows.  On lattices with only singleton/pair groups (e.g. the
    H100-like model) nothing is inferable and the planner degrades to the
    dense batch — the win is for fabrics where ≥3 spaces alias one cache.
    """
    meter = _RowMeter(budget)
    know: dict[frozenset, bool] = {}
    past: list[str] = []
    out: list[SharingResult] = []
    for space_a, cache_size, partners in leaders:
        partners = list(partners)

        def infer(p: str):
            """Flag for (space_a, p) via a witnessing earlier leader."""
            for lead in past:
                ka = know.get(frozenset((lead, space_a)))
                kp = know.get(frozenset((lead, p)))
                if ka is not None and kp is not None and (ka or kp):
                    return ka and kp
            return None

        inferred = [infer(p) for p in partners]
        if partners and all(v is not None for v in inferred) \
                and not meter.exhausted:
            spot = find_sharing_batch(runner, space_a, partners[:1],
                                      cache_size, n_samples)
            meter.charge(1)
            if spot[0].shared == inferred[0]:
                res = [SharingResult(bool(v), space_a, p)
                       for v, p in zip(inferred, partners)]
                for r in res:
                    know[frozenset((space_a, r.space_b))] = r.shared
                out.extend(res)
                past.append(space_a)
                continue
            # spot disagreed with the closure: dense row rules (the spot's
            # request key is cached, so the re-ask costs nothing extra)
        res = find_sharing_batch(runner, space_a, partners, cache_size,
                                 n_samples)
        meter.charge(len(partners))
        for r in res:
            know[frozenset((space_a, r.space_b))] = r.shared
        out.extend(res)
        past.append(space_a)
    return out


# --------------------------------------------------------------------------
# §IV-H CU-pair lattice
# --------------------------------------------------------------------------
def find_cu_sharing_planned(runner, cu_ids, cache_size: int, *,
                            n_samples: int = 33, space: str = "sL1d",
                            budget: SweepBudget) -> CuSharingResult:
    """Hypothesis-first planning for the §IV-H CU↔sL1d pairwise sweep.

    The dense sweep probes each ungrouped leader against every remaining
    candidate — O(n^2) eviction rows.  On real parts sL1d sharing comes in
    small contiguous groups (MI210: adjacent CU pairs), so the planner
    first spot-checks four candidates per leader (the first two, the
    middle, the last, in ONE fused eviction dispatch).  Exactly the
    closed-pair signature — first candidate shared, all other spots
    disjoint — accepts the hypothesis ``group = {leader, first candidate}``
    without probing the rest of the row; ANY other signature (including
    all-disjoint, i.e. an exclusive CU) issues the dense candidate row, so
    the grouping can only shortcut through the verified pair pattern.
    Every flag is a per-pair request-keyed row, identical between the spot
    path and the dense row, so accepted groups match the dense grouping.

    Residual (documented, same contract class as the granularity planner's
    distant-fluke window): a non-contiguous group larger than two whose
    extra members dodge all four spot columns would be split — the second
    member's own leader round then probes densely, bounding the error to
    that group.  Exhausting ``budget.max_rows`` degrades to dense rows.
    """
    cu_ids = list(cu_ids)
    arr = int(cache_size * 0.9)
    hit_ref, miss_ref = _hit_miss_refs(runner, space, arr, cache_size,
                                       n_samples)
    meter = _RowMeter(budget)
    flag_memo: dict[tuple[int, int], bool] = {}

    def shared_flags(cu_a: int, cu_bs) -> list[bool]:
        """Shared-flag for each (cu_a, b) pair; ONE fused eviction call."""
        todo = [b for b in cu_bs if (cu_a, b) not in flag_memo]
        if todo:
            if hasattr(runner, "eviction_many"):
                rows = np.asarray(runner.eviction_many(
                    [("cu", space, cu_a, b, arr) for b in todo], n_samples))
            else:
                rows = np.stack([runner.cu_sharing_probe(
                    cu_a, b, arr, n_samples, space=space) for b in todo])
            meter.charge(len(todo))
            for b, m in zip(todo, classify_miss_rows(rows, hit_ref,
                                                     miss_ref)):
                flag_memo[(cu_a, b)] = bool(m)
        return [flag_memo[(cu_a, b)] for b in cu_bs]

    assigned: dict[int, int] = {}
    groups: list[list[int]] = []
    for i, cu_a in enumerate(cu_ids):
        if cu_a in assigned:
            continue
        group = [cu_a]
        assigned[cu_a] = len(groups)
        candidates = [b for b in cu_ids[i + 1:] if b not in assigned]
        if candidates:
            done = False
            if len(candidates) > 3 and not meter.exhausted:
                mid = len(candidates) // 2
                spots = list(dict.fromkeys(
                    [candidates[0], candidates[1], candidates[mid],
                     candidates[-1]]))
                fmap = dict(zip(spots, shared_flags(cu_a, spots)))
                if fmap[candidates[0]] and \
                        not any(fmap[s] for s in spots if s != candidates[0]):
                    group.append(candidates[0])
                    assigned[candidates[0]] = assigned[cu_a]
                    done = True
            if not done:
                for b, m in zip(candidates, shared_flags(cu_a, candidates)):
                    if m:
                        group.append(b)
                        assigned[b] = assigned[cu_a]
        groups.append(group)
    exclusive = [g[0] for g in groups if len(g) == 1]
    return CuSharingResult(groups, exclusive)
