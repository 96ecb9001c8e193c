"""Topology query service: attribute lookups over many stored topologies.

MT4G's value downstream is that discovered topologies feed other workflows —
performance modeling, bottleneck analysis, dynamic partitioning (paper §V).
That requires topologies to be *queryable artifacts*, not one-shot console
dumps.  ``TopologyService`` serves them from a ``TopologyStore``:

* **attribute lookups** by dotted path — ``query(key, "L1.size")``,
  ``"hbm.bandwidth"`` (element and attribute aliases resolve HBM/DRAM and
  bandwidth/latency spellings), ``"general.clock_domain"``,
  ``"compute.cores_per_sm"`` — each answer carrying the stored value, unit,
  provenance, and K-S confidence;
* **batched lookups** (``query_batch``) that group requests by topology so
  every stored artifact is parsed at most once per batch;
* an **LRU hot set** of deserialized topologies, so repeat traffic over a
  working set of devices never re-reads disk;
* **provenance/confidence filters** (``attributes``) and a **link/sharing
  adjacency** view;
* a **diff endpoint** comparing two stored topologies attribute-by-attribute
  (the regression-tracking workflow: same device, new firmware run).

The service is deliberately in-process and dependency-free — the same layer
an HTTP front end would wrap, exercised directly by tests and benchmarks.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from ..core.topology import Topology

__all__ = ["QueryResult", "AttrDelta", "TopologyDiff", "TopologyService"]

# Element-name aliases: query spellings -> candidate element names, tried in
# order after exact and case-insensitive matching fail.
ELEMENT_ALIASES: dict[str, tuple[str, ...]] = {
    "hbm": ("DeviceMemory", "HBM", "DRAM"),
    "dram": ("DRAM", "DeviceMemory"),
    "device_memory": ("DeviceMemory",),
    "l1": ("L1", "vL1"),
}

ATTR_ALIASES: dict[str, str] = {
    "bandwidth": "read_bw",
    "latency": "load_latency",
}


@dataclass(frozen=True)
class QueryResult:
    """One answered attribute lookup."""

    key: str                     # store key of the topology
    path: str                    # the query as asked
    found: bool
    value: object = None
    unit: str = ""
    provenance: str = ""
    confidence: float | None = None
    element: str = ""            # resolved element name (after aliasing)


@dataclass(frozen=True)
class AttrDelta:
    """One attribute that differs between two topologies."""

    element: str
    attr: str
    a: object
    b: object
    rel_delta: float | None = None   # for numeric values; None otherwise


@dataclass
class TopologyDiff:
    """Structured comparison of two stored topologies."""

    key_a: str
    key_b: str
    only_in_a: list[str] = field(default_factory=list)   # "element" or "element.attr"
    only_in_b: list[str] = field(default_factory=list)
    changed: list[AttrDelta] = field(default_factory=list)
    matching: int = 0                                    # attrs equal within tol

    @property
    def identical(self) -> bool:
        return not (self.only_in_a or self.only_in_b or self.changed)


class TopologyService:
    """Query front end over a ``TopologyStore`` with an LRU hot set.

    Safe under concurrent callers (the threaded HTTP front end): all LRU
    mutation and the hit/miss counters sit behind an internal lock, and
    every cached topology is validated against the store's per-key
    *generation* token before being served — a ``discover(refresh=True)``
    rewrite, a ``gc()`` eviction, or a cross-process writer invalidates the
    hot-set entry instead of pinning the stale object forever.
    """

    def __init__(self, store, hot_set: int = 8):
        self.store = store
        self.hot_set = max(int(hot_set), 1)
        # key -> (store generation at load time, deserialized topology)
        self._lru: OrderedDict[str, tuple[object, Topology]] = OrderedDict()
        self._mutex = threading.Lock()
        self.lru_hits = 0
        self.lru_misses = 0

    # ----------------------------------------------------------- loading
    def get(self, key: str) -> Topology | None:
        """The topology for ``key``, through the generation-checked LRU."""
        with self._mutex:
            cached = self._lru.get(key)
            if cached is not None:
                gen, topo = cached
                if self.store.generation(key) == gen:
                    self.lru_hits += 1
                    self._lru.move_to_end(key)
                    return topo
                del self._lru[key]      # refreshed, GC'd, or quarantined
            self.lru_misses += 1
        # Disk read outside the mutex so misses on different keys do not
        # serialize on each other.  The generation is snapshotted *before*
        # the read: if a writer lands in between, the fresh object is cached
        # under the pre-write token and simply reloads on the next request —
        # the stale direction (new token, old object) cannot happen.
        gen = self.store.generation(key)
        entry = self.store.get(key)
        if entry is None:
            return None
        with self._mutex:
            self._lru[key] = (gen, entry.topology)
            self._lru.move_to_end(key)
            while len(self._lru) > self.hot_set:
                self._lru.popitem(last=False)
        return entry.topology

    def keys(self) -> list[str]:
        return self.store.keys()

    # ----------------------------------------------------------- queries
    @staticmethod
    def _resolve_element(topo: Topology, name: str):
        me = topo.find_memory(name)
        if me is not None:
            return me
        lowered = name.lower()
        for m in topo.memory:
            if m.name.lower() == lowered:
                return m
        for cand in ELEMENT_ALIASES.get(lowered, ()):
            me = topo.find_memory(cand)
            if me is not None:
                return me
        return None

    def query(self, key: str, path: str) -> QueryResult:
        """Answer one dotted-path lookup, e.g. ``"L1.size"`` or
        ``"hbm.bandwidth"``; missing topology/element/attr -> found=False."""
        topo = self.get(key)
        if topo is None:
            return QueryResult(key, path, False)
        root, _, rest = path.partition(".")

        if root == "general":
            a = topo.general.get(rest)
            if a is None:
                return QueryResult(key, path, False)
            return QueryResult(key, path, True, a.value, a.unit,
                               a.provenance, a.confidence, "general")
        if root == "compute":
            ce = topo.find_compute(rest)
            if ce is not None:
                return QueryResult(key, path, True, ce.count, "",
                                   "api", None, ce.name)
            return QueryResult(key, path, False)

        me = self._resolve_element(topo, root)
        if me is None or not rest:
            return QueryResult(key, path, False)
        attr = ATTR_ALIASES.get(rest, rest)
        a = me.attrs.get(attr)
        if a is None:
            return QueryResult(key, path, False)
        return QueryResult(key, path, True, a.value, a.unit, a.provenance,
                           a.confidence, me.name)

    def query_batch(self, requests) -> list[QueryResult]:
        """Answer many ``(key, path)`` lookups, loading each topology once.

        Requests are grouped by key so a batch over K topologies costs K
        loads (at most — the hot set usually absorbs them), not len(requests).
        """
        by_key: dict[str, list[int]] = {}
        for i, (key, _path) in enumerate(requests):
            by_key.setdefault(key, []).append(i)
        out: list[QueryResult | None] = [None] * len(requests)
        for key, idxs in by_key.items():
            self.get(key)            # one load; query() then hits the LRU
            for i in idxs:
                out[i] = self.query(key, requests[i][1])
        return out

    def attributes(self, key: str, *, provenance: str | None = None,
                   min_confidence: float | None = None) -> list[QueryResult]:
        """All memory attributes of a topology, filtered by provenance and/or
        minimum confidence (paper-style reliability filtering)."""
        topo = self.get(key)
        if topo is None:
            return []
        out = []
        for me in topo.memory:
            for attr, a in me.attrs.items():
                if provenance is not None and a.provenance != provenance:
                    continue
                if min_confidence is not None and (
                        a.confidence is None or a.confidence < min_confidence):
                    continue
                out.append(QueryResult(key, f"{me.name}.{attr}", True,
                                       a.value, a.unit, a.provenance,
                                       a.confidence, me.name))
        return out

    def adjacency(self, key: str) -> dict[str, list[str]]:
        """Sharing/link adjacency: element -> peers it physically shares
        silicon or an interconnect edge with."""
        topo = self.get(key)
        if topo is None:
            return {}
        adj: dict[str, list[str]] = {}
        for me in topo.memory:
            if me.shared_with:
                adj[me.name] = list(me.shared_with)
        for link in topo.links:
            a, b = link.endpoints
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        return adj

    # -------------------------------------------------------------- diff
    def diff(self, key_a: str, key_b: str,
             rel_tol: float = 0.0) -> TopologyDiff:
        """Attribute-level comparison of two stored topologies.

        Numeric attributes within ``rel_tol`` relative difference count as
        matching (measurement jitter between runs of the same device);
        non-numeric attributes must be equal.
        """
        ta, tb = self.get(key_a), self.get(key_b)
        if ta is None or tb is None:
            missing = [k for k, t in ((key_a, ta), (key_b, tb)) if t is None]
            raise KeyError(f"topologies not in store: {missing}")
        d = TopologyDiff(key_a=key_a, key_b=key_b)

        names_a = {m.name for m in ta.memory}
        names_b = {m.name for m in tb.memory}
        d.only_in_a += sorted(names_a - names_b)
        d.only_in_b += sorted(names_b - names_a)

        for name in sorted(names_a & names_b):
            ma, mb = ta.find_memory(name), tb.find_memory(name)
            for attr in sorted(set(ma.attrs) | set(mb.attrs)):
                aa, ab = ma.attrs.get(attr), mb.attrs.get(attr)
                if aa is None:
                    d.only_in_b.append(f"{name}.{attr}")
                    continue
                if ab is None:
                    d.only_in_a.append(f"{name}.{attr}")
                    continue
                rel = _rel_delta(aa.value, ab.value)
                if rel is not None:
                    if rel <= rel_tol:
                        d.matching += 1
                    else:
                        d.changed.append(AttrDelta(name, attr, aa.value,
                                                   ab.value, rel))
                elif aa.value == ab.value:
                    d.matching += 1
                else:
                    d.changed.append(AttrDelta(name, attr, aa.value, ab.value))
            if ma.shared_with != mb.shared_with:
                d.changed.append(AttrDelta(name, "shared_with",
                                           list(ma.shared_with),
                                           list(mb.shared_with)))
        return d

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._mutex:
            return {"lru_hits": self.lru_hits,
                    "lru_misses": self.lru_misses,
                    "hot_set": len(self._lru), "store": self.store.stats()}


def _rel_delta(a, b) -> float | None:
    """Relative difference for numeric scalars; None if not comparable."""
    if isinstance(a, bool) or isinstance(b, bool):
        return None
    if not (isinstance(a, (int, float)) and isinstance(b, (int, float))):
        return None
    denom = max(abs(a), abs(b))
    if denom == 0:
        return 0.0
    return abs(a - b) / denom
