"""The port's fault tolerance: supervisor, straggler detector, failure
injection.

* The reference's ``TestFaultTolerance`` cases (``tests/test_substrate.py``)
  re-pointed at ``repro_torch``; the restart case also with bfloat16
  parameters and a float32 master.
* ``StragglerDetector`` gives the reference's verdicts and ``flagged`` list
  on hypothesis-drawn step durations, windows and thresholds.
* ``Supervisor`` runs scripted train functions over a fake checkpointer
  (a save in flight until ``wait()``, restores returning the saved tree)
  and gives the reference ``Supervisor``'s restarts, log, starts and
  results, or raises ``RestartExhausted`` where it does.
* A restart from scratch after in-place train steps starts from the
  initial values (the port's step writes its state in place, and the
  reference reuses the object it was given): the final state equals an
  uninterrupted run's bit for bit.  A bfloat16 state restarts from its
  checkpoint and ends equal to an uninterrupted run, where the reference's
  supervisor raises out of its restore.
* The failed attempt's frames are cleared before the restore: a tensor
  that only the failed step held is freed by then.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.checkpoint as jcheckpoint
import repro.ft as jft
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import ByteCorpus, DataConfig
from repro_torch.ft import (FailureInjector, RestartExhausted,
                            StragglerDetector, Supervisor)
from repro_torch.models import get_model
from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                               make_train_step, train_loop)
from repro_torch.train.optimizer import tree_leaves, tree_map

DTYPES = ["float32", "bfloat16"]


def _tiny_setup(dtype="float32", steps_total=64):
    cfg = tconfigs.get_config("internlm2-1.8b").smoke().replace(dtype=dtype)
    model = get_model(cfg)
    tc = TrainConfig(
        opt=OptConfig(lr=3e-3, warmup_steps=4, total_steps=steps_total,
                      master_f32=True), ckpt_every=4)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    return cfg, model, tc, data


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _assert_bitwise(a_tree, b_tree):
    a, b = tree_leaves(a_tree), tree_leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestFaultTolerance:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_supervisor_restarts_and_completes(self, tmp_path, dtype):
        cfg, model, tc, data = _tiny_setup(dtype)
        ck = Checkpointer(str(tmp_path))
        s0 = init_train_state(model, 4, tc, device="cpu")
        step_fn = make_train_step(model, tc)
        injector = FailureInjector(fail_at={6})

        def train_fn(state, start):
            return train_loop(model, tc, data, steps=10, state=state,
                              start_step=start, checkpointer=ck,
                              step_fn=step_fn, callbacks=[injector])

        sup = Supervisor(ck, max_restarts=2)
        state, hist = sup.run(train_fn, s0)
        assert sup.restarts == 1
        assert any("restart from step" in l for l in sup.log)
        assert hist[-1][0] == 9              # completed all steps

    def test_supervisor_gives_up(self, tmp_path):
        ck = Checkpointer(str(tmp_path))

        def bad_fn(state, start):
            raise RuntimeError("always broken")

        sup = Supervisor(ck, max_restarts=2)
        with pytest.raises(RestartExhausted):
            sup.run(bad_fn, {"x": torch.zeros(1)})

    def test_straggler_detector(self):
        det = StragglerDetector(threshold_sigmas=4.0)
        for i in range(20):
            assert not det.record(i, 1.0 + 0.01 * (i % 3))
        assert det.record(20, 5.0)           # 5x median -> flagged
        assert det.flagged and det.flagged[0][0] == 20


def test_failure_injector_fires_once_a_step():
    inj = FailureInjector(fail_at={1, 3})
    inj(0, {})
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        inj(1, {})
    inj(1, {})
    with pytest.raises(RuntimeError, match="step 3"):
        inj(3, {})
    assert inj.fired == {1, 3}


# ----------------------------------------------------------------------------
# the straggler detector against the reference's
# ----------------------------------------------------------------------------
_durations = st.lists(st.one_of(
    st.floats(0.05, 2.0), st.floats(2.0, 40.0),
    st.sampled_from([1.0, 1.0, 1.0, 0.5])), min_size=1, max_size=90)


@settings(max_examples=60, deadline=None)
@given(durations=_durations, sigmas=st.sampled_from([0.5, 2.0, 4.0]),
       window=st.sampled_from([3, 10, 50]))
def test_straggler_verdicts_equal_reference(durations, sigmas, window):
    ref = jft.StragglerDetector(threshold_sigmas=sigmas, window=window)
    port = StragglerDetector(threshold_sigmas=sigmas, window=window)
    for step, s in enumerate(durations):
        assert port.record(step, s) == ref.record(step, s), step
    assert port.flagged == ref.flagged
    assert port.durations == ref.durations


# ----------------------------------------------------------------------------
# the supervisor against the reference's, on scripted train functions
# ----------------------------------------------------------------------------
class FakeCheckpointer:
    """Saves become visible at ``wait()`` (an async writer in flight);
    restore returns the saved tree."""

    def __init__(self):
        self.saved, self.pending, self.calls = {}, {}, []

    def save_async(self, step, tree):
        self.pending[step] = tree

    def wait(self):
        self.calls.append("wait")
        self.saved.update(self.pending)
        self.pending.clear()

    def latest_step(self):
        self.calls.append("latest_step")
        return max(self.saved) if self.saved else None

    def restore(self, template, step=None):
        self.calls.append(("restore", step))
        return self.saved[step], {}


# each attempt: ("fail", save_step or None) or ("ok", steps done)
SCRIPTS = {
    "clean": [("ok", 8)],
    "fail-no-checkpoint": [("fail", None), ("ok", 8)],
    "fail-after-save": [("fail", 4), ("ok", 8)],
    "fail-twice": [("fail", None), ("fail", 4), ("ok", 8)],
    "fail-save-fail": [("fail", 2), ("fail", 6), ("ok", 9)],
    "exhausted": [("fail", None), ("fail", 4), ("fail", 6), ("fail", None)],
}


def _run_script(sup_cls, exhausted_cls, script, state):
    ck = FakeCheckpointer()
    sup = sup_cls(ck, max_restarts=3)
    starts = []

    def train_fn(st, start):
        action, arg = script[len(starts)]
        starts.append(start)
        if action == "ok":
            return st, [(s, {"loss": float(s)}) for s in range(start, arg)]
        if arg is not None:
            ck.save_async(arg, st)
        raise RuntimeError(f"attempt {len(starts)} failed")

    try:
        _, hist = sup.run(train_fn, state)
    except exhausted_cls as e:
        hist = f"exhausted: {e}"
    return {"restarts": sup.restarts, "log": sup.log, "starts": starts,
            "hist": hist, "calls": ck.calls}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_supervisor_equals_reference_on_scripts(name):
    script = SCRIPTS[name]
    ref = _run_script(jft.Supervisor, jft.RestartExhausted, script,
                      {"x": jnp.zeros(3)})
    port = _run_script(Supervisor, RestartExhausted, script,
                       {"x": torch.zeros(3)})
    assert port == ref
    if name == "exhausted":
        assert port["hist"] == "exhausted: gave up after 3 restarts"


# ----------------------------------------------------------------------------
# in-place state: restarts from scratch and from a bfloat16 checkpoint
# ----------------------------------------------------------------------------
def _supervised(tmp_path, dtype, fail_at, seed=7):
    cfg, model, tc, data = _tiny_setup(dtype)
    s0 = init_train_state(model, seed, tc, device="cpu")
    step_fn = make_train_step(model, tc)
    want, _ = train_loop(model, tc, data, steps=10, state=_clone(s0),
                         step_fn=step_fn)
    ck = Checkpointer(str(tmp_path))
    injector = FailureInjector(fail_at=fail_at)

    def train_fn(state, start):
        return train_loop(model, tc, data, steps=10, state=state,
                          start_step=start, checkpointer=ck,
                          step_fn=step_fn, callbacks=[injector])

    sup = Supervisor(ck, max_restarts=2)
    initial = _clone(s0)
    got, hist = sup.run(train_fn, s0)
    return sup, got, hist, want, initial


@pytest.mark.parametrize("dtype", DTYPES)
def test_restart_from_scratch_after_in_place_steps(tmp_path, dtype):
    sup, got, hist, want, initial = _supervised(tmp_path, dtype, {2})
    assert sup.restarts == 1
    assert sup.log == ["failure: RuntimeError('injected failure at step 2')",
                       "restart from scratch (no checkpoint)"]
    assert [s for s, _ in hist] == list(range(10))
    _assert_bitwise(got, want)
    assert sup.snapshot_bytes == sum(t.numel() * t.element_size()
                                     for t in tree_leaves(initial))


@pytest.mark.parametrize("dtype", DTYPES)
def test_restart_from_checkpoint_equals_uninterrupted(tmp_path, dtype):
    sup, got, hist, want, _ = _supervised(tmp_path, dtype, {6})
    assert sup.restarts == 1
    assert sup.log == ["failure: RuntimeError('injected failure at step 6')",
                       "restart from step 4"]
    assert [s for s, _ in hist] == list(range(4, 10))
    _assert_bitwise(got, want)


def test_reference_supervisor_cannot_restart_a_bfloat16_state(tmp_path):
    """The reference's supervisor, on its own checkpointer, raises out of
    its restore of a bfloat16 tree; the port's restarts from it."""
    def script(ck):
        def train_fn(state, start):
            if start == 0:
                ck.save(1, state)
                raise RuntimeError("step 1 failed")
            return state, [(start, {})]
        return train_fn

    jck = jcheckpoint.Checkpointer(str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="cast"):
        jft.Supervisor(jck, max_restarts=2).run(
            script(jck), {"w": jnp.ones(4, jnp.bfloat16)})
    ck = Checkpointer(str(tmp_path / "port"))
    w = torch.full((4,), 1.5, dtype=torch.bfloat16)
    sup = Supervisor(ck, max_restarts=2)
    state, hist = sup.run(script(ck), {"w": w})
    assert sup.log[-1] == "restart from step 1" and hist == [(1, {})]
    assert state["w"].dtype == torch.bfloat16 and torch.equal(state["w"], w)


def test_failed_attempt_is_freed_before_the_restore():
    held = []

    class Probe(FakeCheckpointer):
        def restore(self, template, step=None):
            gc.disable()           # only reference counts may free it
            try:
                held.append(held[0]() is None)
            finally:
                gc.enable()
            return super().restore(template, step)

    ck = Probe()
    ck.saved[3] = {"x": torch.ones(2)}

    def train_fn(state, start):
        if start == 0:
            activations = torch.empty(1 << 16)
            held.append(weakref.ref(activations))
            raise RuntimeError("out of memory, say")
        return state, []

    sup = Supervisor(ck)
    sup.run(train_fn, {"x": torch.zeros(2)})
    assert held[1] is True
    assert sup.log == ["failure: RuntimeError('out of memory, say')",
                       "restart from step 3"]
