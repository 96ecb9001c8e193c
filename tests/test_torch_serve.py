"""The port's serving path, held to the reference's, and what it refuses.

* ``Engine.serve`` with greedy sampling gives the reference ``Engine``'s
  tokens, on the same converted float32 weights and requests (two waves,
  the second part-full), for the dense, ssm, moe and hybrid families.  The
  reference's ``init`` folds ``hash(name)`` into its keys, which Python
  salts in every process, so these weights differ from run to run, and in
  some runs a step's two best logits may lie closer than the two
  packages' float32 sums part: there greedy sampling may pick either.
  So the port is also run on the reference's tokens, its logits at every
  step held to the reference's within 1e-4, its own pick to the
  reference's wherever the reference's top-2 margin exceeds twice that
  (two logits each within the tolerance can swap a margin up to twice
  it), and the free-running tokens of a request equal up to its first
  step whose margin does not.
* ``launch.serve.main(... --device cpu)`` returns its numbers, and its
  prefill went through the family's kernel wrapper once per layer (once per
  site of the shared block for hybrid) and wave.
* The entry point that is not ported (``Runtime(moe_impl="ep")``) raises
  ``NotImplementedError`` naming the missing module, and a ``--mesh`` of
  more devices than ranks and ``shardings`` that are not (mesh,
  placements) pairs raise naming what they need; none launches anything
  (every family is ported; ``test_torch_audio_vlm.py`` serves audio and
  vlm; meshes of several ranks serve in ``test_torch_elastic.py``).
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro_torch.configs as tconfigs
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.checkpoint import Checkpointer
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime, get_model, zamba2
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Engine, ServeConfig

ARCHS = {"qwen3-14b-smoke": dict(n_heads=6, n_kv_heads=2),
         "rwkv6-3b-smoke": {},
         "qwen3-moe-30b-a3b-smoke": {},
         "zamba2-2.7b-smoke": {}}


LOGIT_TOL = 1e-4
SLOTS, NEW = 4, 5


def _recording(engine, to_numpy, forced=None):
    """Record the logits of each sampling call of ``engine`` (a wave's
    prefill, then each decode step); with ``forced``, a list of id arrays,
    return the call's ids from it instead of the engine's own pick, which
    is recorded beside."""
    calls, own = [], []
    sample = engine._sample

    def record(logits, rng):
        calls.append(to_numpy(logits))
        ids = sample(logits, rng)
        own.append(np.asarray(ids))
        return ids if forced is None else forced[len(calls) - 1]

    engine._sample = record
    return calls, own


def _parting(req, step, want, got, ref_logits):
    """Where a request's tokens part: the step, both token rows and the
    reference's top-2 margin there."""
    wave_row = divmod(req, SLOTS)
    top = np.sort(ref_logits[wave_row[0] * NEW + step][wave_row[1]])
    return (f"request {req} parts at step {step}: port {got.tolist()}, "
            f"reference {want.tolist()}, reference top-2 margin there "
            f"{top[-1] - top[-2]:g}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_serve_tokens_equal_reference(arch):
    kw = dict(ARCHS[arch], dtype="float32")
    jcfg = jconfigs.get_config(arch).replace(**kw)
    tcfg = tconfigs.get_config(arch).replace(**kw)
    jmodel = jmodels.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, tcfg.vocab_size, 12).astype(np.int32)
            for _ in range(6)]
    jeng = JEngine(jmodel, jparams, JServeConfig(max_len=32, slots=SLOTS))
    ref_logits, ref_ids = _recording(jeng, lambda x: np.array(x, np.float32))
    want = jeng.serve(reqs, max_new=NEW)
    assert len(ref_logits) == 2 * NEW

    # the port on the reference's tokens: its logits at every step
    forced = Engine(get_model(tcfg), tparams,
                    ServeConfig(max_len=32, slots=SLOTS, device="cpu"))
    port_logits, port_ids = _recording(
        forced, lambda x: x.float().numpy().copy(), forced=ref_ids)
    assert all(np.array_equal(g, w) for g, w in
               zip(forced.serve(reqs, max_new=NEW), want))
    assert len(port_logits) == len(ref_logits)
    near_tie = []
    for call, (got_l, want_l) in enumerate(zip(port_logits, ref_logits)):
        np.testing.assert_allclose(got_l, want_l, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"call {call}")
        top = np.sort(want_l, axis=-1)
        tie = top[:, -1] - top[:, -2] <= 2 * LOGIT_TOL
        near_tie.append(tie)
        np.testing.assert_array_equal(port_ids[call][~tie],
                                      ref_ids[call][~tie],
                                      err_msg=f"call {call}")

    eng = Engine(get_model(tcfg), tparams,
                 ServeConfig(max_len=32, slots=SLOTS, device="cpu"))
    got = eng.serve(reqs, max_new=NEW)
    assert len(got) == len(want) == 6
    for req, (g, w) in enumerate(zip(got, want)):
        wave, row = divmod(req, SLOTS)
        ties = [step for step in range(NEW)
                if near_tie[wave * NEW + step][row]]
        upto = ties[0] if ties else NEW
        if not np.array_equal(g[:upto], w[:upto]):
            step = int(np.argmax(g[:upto] != w[:upto]))
            pytest.fail(_parting(req, step, w, g, ref_logits))
    assert eng.stats["prefills"] == 2 and eng.stats["decode_steps"] == 8


@pytest.mark.parametrize("arch,kernel", [("qwen3-14b-smoke", "mha"),
                                         ("rwkv6-3b-smoke", "wkv6"),
                                         ("qwen3-moe-30b-a3b-smoke", "mha"),
                                         ("zamba2-2.7b-smoke", "mha")])
def test_launcher_returns_numbers_and_counts_launches(arch, kernel, capsys):
    ops.reset_launches()
    res = launch_serve.main(["--arch", arch, "--device", "cpu",
                             "--requests", "6", "--prompt-len", "10",
                             "--max-new", "4", "--max-len", "16",
                             "--slots", "4"])
    cfg = tconfigs.get_config(arch)
    waves = 2
    per_wave = zamba2.n_sites(cfg) if cfg.family == "hybrid" \
        else cfg.n_layers
    assert res["launches"] == {"mha": 0, "wkv6": 0, "pchase": 0,
                               kernel: per_wave * waves}
    assert res["new_tokens"] == 6 * 4 == sum(o.size for o in res["outputs"])
    assert res["arch"] == arch and res["device"] == "cpu"
    assert res["wall_s"] > 0 and res["tok_per_s"] > 0
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    assert all(o.shape == (4,) for o in res["outputs"])
    assert "[serve] arch=" + arch in capsys.readouterr().out
    assert res["engine"].params["embed"].dtype == torch.float32


def _unported_calls(root=None):
    def model(arch, **kw):
        return get_model(tconfigs.get_config(arch).replace(**kw))

    dense = model("qwen3-14b-smoke", dtype="float32")
    tokens = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    argv = ["--arch", "qwen3-14b-smoke", "--device", "cpu"]
    return {
        # moe_impl="ep" is ported (models/moe_ep.py); an unknown moe
        # implementation is refused naming both modules
        "moe-ep": (lambda: Runtime(moe_impl="tp"), ValueError,
                   "moe_ep.py"),
        # a 2x2 mesh needs 4 ranks (torchrun); this process is one
        "mesh": (lambda: launch_serve.main(argv + ["--mesh", "2x2"]),
                 ValueError, "4 devices"),
        "ckpt-dir": (lambda: Checkpointer(str(root)).restore(
            {"embed": torch.zeros(1)}, shardings={"embed": None}),
                     TypeError, "sharding.tree_shardings"),
    }


@pytest.mark.parametrize("case", list(_unported_calls()))
def test_unported_parts_raise_naming_the_module(case, tmp_path):
    call, error, module = _unported_calls(tmp_path)[case]
    ops.reset_launches()
    with pytest.raises(error, match=module):
        call()
    assert all(fn.launches == 0 for fn in ops.WRAPPERS + ops.LLM_WRAPPERS)


def test_entry_points_default_to_the_card():
    """The engine, the model's initializer and the launcher run on the card
    unless asked for the CPU; without one they raise, never fall back."""
    model = get_model(tconfigs.get_config("qwen3-14b-smoke"))
    assert ServeConfig().device == "cuda"
    assert inspect.signature(model.init).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen3-14b-smoke"])
    params = model.init(device="cpu")
    with pytest.raises(ValueError, match="ServeConfig.device"):
        Engine(model, params, ServeConfig())
    assert all(fn.launches == 0 for fn in ops.WRAPPERS + ops.LLM_WRAPPERS)
