"""Link adjacency in the port against the reference package.

``TestLinkAdjacency`` is the reference's class of ``tests/test_probes.py``
re-pointed at ``repro_torch``: direct links told from routed paths by the
change point of the sorted pairwise latencies, on simulated tori.  The
cross-check feeds both packages the same seeded ``SimPod`` and holds their
``AdjacencyResult`` equal bit for bit: neighbours, threshold and every
pair's median latency.
"""
import pytest
from _hypothesis_compat import given, settings, st

import repro.core.probes as ref_probes
import repro_torch.core.probes as port_probes
from repro.core.probes.adjacency import SimPod as RefSimPod
from repro.core.probes.adjacency import \
    find_link_adjacency as ref_find_link_adjacency


class TestLinkAdjacency:
    """Pod-level §IV-H analogue: direct links vs routed paths."""

    def test_torus_neighbors_recovered(self):
        from repro_torch.core.probes.adjacency import (SimPod,
                                                       find_link_adjacency)
        pod = SimPod(rows=4, cols=4, seed=3)
        res = find_link_adjacency(pod, n_samples=9)
        assert res.found
        for chip in range(pod.n_chips):
            assert res.neighbors[chip] == pod.neighbors(chip), chip

    def test_degree_is_four_on_2d_torus(self):
        from repro_torch.core.probes.adjacency import (SimPod,
                                                       find_link_adjacency)
        pod = SimPod(rows=4, cols=8, seed=5)
        res = find_link_adjacency(pod, chips=list(range(16)), n_samples=9)
        assert res.found
        # probing a sub-slice still finds only true direct links
        for chip, peers in res.neighbors.items():
            assert set(peers) <= set(pod.neighbors(chip))

    @given(rows=st.sampled_from([2, 4]), cols=st.sampled_from([4, 8]),
           seed=st.integers(0, 30))
    @settings(max_examples=10, deadline=None)
    def test_property_any_torus_shape(self, rows, cols, seed):
        from repro_torch.core.probes.adjacency import (SimPod,
                                                       find_link_adjacency)
        pod = SimPod(rows=rows, cols=cols, seed=seed)
        res = find_link_adjacency(pod, n_samples=9)
        assert res.found
        ok = sum(res.neighbors[c] == pod.neighbors(c)
                 for c in range(pod.n_chips))
        assert ok >= 0.95 * pod.n_chips


@pytest.mark.parametrize("rows, cols", [(2, 4), (4, 4), (4, 8)])
@pytest.mark.parametrize("seed", [0, 3, 5, 17, 29])
def test_adjacency_equals_reference(rows, cols, seed):
    """Bit-equal on the same seeded pod: the whole pod, and a sub-slice of
    its chips at another sample count."""
    for chips, n_samples in ((None, 9), (list(range(0, rows * cols, 2)), 5)):
        pod = port_probes.SimPod(rows=rows, cols=cols, seed=seed)
        ref_pod = RefSimPod(rows=rows, cols=cols, seed=seed)
        got = port_probes.find_link_adjacency(pod, chips=chips,
                                              n_samples=n_samples)
        want = ref_find_link_adjacency(ref_pod, chips=chips,
                                       n_samples=n_samples)
        assert got.found == want.found
        assert got.neighbors == want.neighbors
        assert got.threshold_us == want.threshold_us
        assert got.pair_latency == want.pair_latency
        assert [pod.neighbors(c) for c in range(pod.n_chips)] == \
            [ref_pod.neighbors(c) for c in range(ref_pod.n_chips)]


def test_exports_match_reference():
    """The port's probes package exports the reference's adjacency and
    collective names."""
    names = ("AdjacencyResult", "SimPod", "find_link_adjacency",
             "CollectiveEstimate", "all_to_all_time", "measure_collective",
             "ring_all_gather_time", "ring_all_reduce_time", "HostRunner")
    for name in names:
        assert name in ref_probes.__all__ and name in port_probes.__all__
        assert getattr(port_probes, name).__module__.startswith(
            "repro_torch.")
