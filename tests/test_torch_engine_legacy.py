"""The port's legacy sequential discovery against the reference's and the
port's engine.

``discover_sim_legacy`` is the paper-faithful loop, one probe family at a
time: the oracle the reference's ``tests/test_engine.py`` holds its engine
to.  Here the port's loop must equal the reference's bit for bit on the
same request-keyed simulated devices (memory attributes and compute
elements; the notes carry wall times and are excluded), and the port's
engine must equal the port's loop under the reference's own contract
(``topology_equivalent``: discrete attributes exact, floats within a
relative tolerance), as ``TestEngineEqualsLegacy`` asks of the reference.
"""
import pytest

import repro.core as ref
from repro_torch.core import (discover_sim, discover_sim_legacy,
                              make_h100_like, make_mi210_like,
                              topology_equivalent)

DEVICES = [("make_h100_like", 11), ("make_h100_like", 48),
           ("make_mi210_like", 12), ("make_mi210_like", 48)]
IDS = [f"{name[5:-5]}-{seed}" for name, seed in DEVICES]
MAKERS = {"make_h100_like": make_h100_like,
          "make_mi210_like": make_mi210_like}


def _without_notes(topo) -> dict:
    d = topo.to_json()
    d.pop("notes")
    return d


@pytest.mark.parametrize("name,seed", DEVICES, ids=IDS)
def test_legacy_equals_reference_legacy(name, seed):
    got, timings = discover_sim_legacy(MAKERS[name](seed=seed), n_samples=17)
    want, ref_timings = ref.discover_sim_legacy(
        getattr(ref, name)(seed=seed), n_samples=17)
    assert _without_notes(got) == _without_notes(want)
    assert set(timings.per_family) == set(ref_timings.per_family)
    assert timings.meta == ref_timings.meta == {}


@pytest.mark.parametrize("elements", [["L1", "L2"], ["sL1d"], ["vL1"]],
                         ids=["L1-L2", "sL1d", "vL1"])
def test_legacy_element_restriction_equals_reference(elements):
    name = "make_h100_like" if "L1" in elements else "make_mi210_like"
    got, _ = discover_sim_legacy(MAKERS[name](seed=5), n_samples=9,
                                 elements=elements)
    want, _ = ref.discover_sim_legacy(getattr(ref, name)(seed=5),
                                      n_samples=9, elements=elements)
    assert _without_notes(got) == _without_notes(want)


@pytest.mark.parametrize("name,seed", DEVICES, ids=IDS)
def test_engine_equals_legacy(name, seed):
    """Engine == legacy: discrete attributes (sizes, line sizes,
    granularities, amounts, sharing) exactly equal, float metrics within
    relative tolerance."""
    topo_l, _ = discover_sim_legacy(MAKERS[name](seed=seed), n_samples=17)
    topo_e, te = discover_sim(MAKERS[name](seed=seed), n_samples=17)
    assert topology_equivalent(topo_l, topo_e, rel_tol=1e-6)
    assert set(te.per_family) >= {"size", "latency", "bandwidth"}


def test_discover_sim_without_the_engine_is_the_legacy_loop():
    got, timings = discover_sim(make_h100_like(seed=7), n_samples=9,
                                engine=False)
    want, _ = discover_sim_legacy(make_h100_like(seed=7), n_samples=9)
    assert _without_notes(got) == _without_notes(want)
    assert timings.probe_rows is None            # the loop counts no rows


def test_equivalence_is_discrete_strict():
    """The relaxed contract still rejects discrete drift: a one-byte size
    change must not count as equivalent, a float within rel-tol must."""
    topo_a, _ = discover_sim_legacy(make_h100_like(seed=5), n_samples=9)
    topo_b, _ = discover_sim_legacy(make_h100_like(seed=5), n_samples=9)
    assert topology_equivalent(topo_a, topo_b)
    l1 = topo_b.find_memory("L1")
    l1.attrs["size"].value += 1
    assert not topology_equivalent(topo_a, topo_b)
    l1.attrs["size"].value -= 1
    l1.attrs["load_latency"].value *= 1.0 + 1e-9
    assert topology_equivalent(topo_a, topo_b)
    l1.attrs["load_latency"].value *= 1.01
    assert not topology_equivalent(topo_a, topo_b)
