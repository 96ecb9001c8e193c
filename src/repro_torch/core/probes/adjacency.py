"""Link-adjacency discovery — the pod-level analogue of paper §IV-H.

MT4G answers "which CU ids share one sL1d" by pairwise eviction probes. On a
pod of accelerators the corresponding topological unknown is "which chips
share a direct link" (vs. multi-hop routed paths): the same pairwise
measurement shape, with a point-to-point transfer's latency as the signal
instead of cache eviction.

Workflow (mirrors find_cu_sharing):
  1. measure the pairwise one-hop permute latency for chip pairs;
  2. the sorted pairwise latencies form a stepped series (1 hop, 2 hops, ...);
     the K-S change point on that series separates direct links from routed
     paths — no assumptions about the torus shape are made;
  3. report the adjacency list; a mesh can then be checked to map its
     axes onto physical neighbors (mis-wired "model" axes show up immediately).

Runners: ``SimPod`` (ground-truth torus with latency noise/outliers — the
validation path), or any object with ``n_chips`` and
``permute_latency(a, b, n_samples)``.  The reference package's copy of this
module is the same numpy code, so both find the same links from the same
seeded pod.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..stats import ks_change_point, pelt_segments

__all__ = ["SimPod", "AdjacencyResult", "find_link_adjacency"]


@dataclass
class SimPod:
    """Virtual pod: chips on a (rows, cols) 2-D torus with per-hop latency."""

    rows: int
    cols: int
    hop_latency_us: float = 2.0
    routing_overhead_us: float = 1.0     # per extra hop
    noise_us: float = 0.15
    outlier_prob: float = 0.005
    outlier_scale: float = 20.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def n_chips(self) -> int:
        return self.rows * self.cols

    def _coords(self, chip: int) -> tuple[int, int]:
        return divmod(chip, self.cols)

    def hops(self, a: int, b: int) -> int:
        (ra, ca), (rb, cb) = self._coords(a), self._coords(b)
        dr = min(abs(ra - rb), self.rows - abs(ra - rb))   # torus wraparound
        dc = min(abs(ca - cb), self.cols - abs(ca - cb))
        return dr + dc

    def neighbors(self, chip: int) -> list[int]:
        return sorted(b for b in range(self.n_chips)
                      if b != chip and self.hops(chip, b) == 1)

    def permute_latency(self, a: int, b: int, n_samples: int) -> np.ndarray:
        h = self.hops(a, b)
        mean = h * self.hop_latency_us + max(h - 1, 0) * self.routing_overhead_us
        lat = self._rng.normal(mean, self.noise_us, n_samples)
        mask = self._rng.random(n_samples) < self.outlier_prob
        lat[mask] *= self.outlier_scale
        return np.maximum(lat, 0.05)


@dataclass
class AdjacencyResult:
    neighbors: dict[int, list[int]]          # chip -> direct-link peers
    threshold_us: float                      # detected 1-hop/2-hop boundary
    found: bool
    pair_latency: dict[tuple[int, int], float] = field(default_factory=dict)

    def degree(self, chip: int) -> int:
        return len(self.neighbors.get(chip, []))


def find_link_adjacency(pod, chips: list[int] | None = None,
                        n_samples: int = 9, alpha: float = 0.01
                        ) -> AdjacencyResult:
    """Pairwise permute sweep -> K-S change point on sorted medians ->
    direct-link adjacency (no torus-shape assumptions, like §IV-H makes no
    CU-layout assumptions)."""
    chips = chips if chips is not None else list(range(pod.n_chips))
    med: dict[tuple[int, int], float] = {}
    for i, a in enumerate(chips):
        for b in chips[i + 1:]:
            lat = pod.permute_latency(a, b, n_samples)
            med[(a, b)] = float(np.median(lat))   # outlier-robust per §IV-C

    values = np.array(sorted(med.values()))
    # The sorted series is MULTI-step (1/2/3... hop groups): PELT segments
    # all of them; the FIRST boundary separates direct links from routed
    # paths. (A single K-S change point finds the most significant split,
    # which on a large torus is a mid-hop boundary — measured and rejected
    # in development; PELT is one of the paper's 'other algorithms'.)
    # Log space: hop latencies are multiplicative groups; in linear space
    # the BIC penalty (global variance) can swallow the small 1-hop group on
    # skewed tori (2xN), merging it with 2-hop.
    cps = pelt_segments(np.log(values))
    if cps:
        idx = cps[0]
    else:
        cp = ks_change_point(values, alpha=alpha, min_segment=2)
        if not cp.found or cp.index <= 0:
            return AdjacencyResult({}, -1.0, False, med)
        idx = cp.index
    threshold = float((values[idx - 1] + values[idx]) / 2.0)

    neighbors: dict[int, list[int]] = {c: [] for c in chips}
    for (a, b), m in med.items():
        if m < threshold:
            neighbors[a].append(b)
            neighbors[b].append(a)
    return AdjacencyResult({c: sorted(v) for c, v in neighbors.items()},
                           threshold, True, med)
