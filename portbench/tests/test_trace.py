"""The reduction of a profiler session: parts split at markers, read from
the session's end, the busy union, idle gaps by unit and the readers."""
import pytest

import run as R
from harness.readers import RunView, idle_percent, mfu_percent
from harness.spec import Shape
from harness.trace import split

M = "marker"
S = Shape(name="t", n_layers=2, d_model=8, n_heads=4, n_kv_heads=2,
          head_dim=2, d_ff=16, vocab=10, qk_norm=False, rope_theta=1e4,
          norm_eps=1e-6, dtype="bfloat16")


def ev(name, s, e):
    return (name, s, e)


def session(first_missing=False):
    evs = [] if first_missing else [ev(M, 0, 1000)]      # the lead-in spin
    evs += [ev(M, 1000, 1001), ev(M, 1001, 1002),          # lead-in markers
            ev("gemm", 2000, 3000), ev("flash_fwd_sm90_kernel<128>",
                                       3500, 4000),
            ev(M, 4000, 4001),                             # closes prefill
            ev("gemv", 6000, 6500), ev("copy", 6600, 7000),
            ev(M, 7000, 7001),                             # closes decode
            ev(M, 7001, 7002),                             # waiting: nothing
            ev("gemm", 9000, 9500),
            ev(M, 9500, 9501),                             # closes prefill
            ev(M, 9600, 9601)]                             # closes window
    return evs


LABELS = [("prefill_64", {"kind": "prefill", "batch": 1, "seq": 64}),
          ("decode_step", {"kind": "decode", "batch": 1, "valid": 65}),
          ("waiting for arrivals", {}),
          ("prefill_64", {"kind": "prefill", "batch": 1, "seq": 64})]


@pytest.mark.parametrize("first_missing", [False, True])
def test_split_reads_from_the_end(first_missing):
    tr = split(session(first_missing), M, LABELS, window_s=10e-6)
    assert tr is not None and tr.stray == 0
    assert [p.label for p in tr.parts] == [lb for lb, _ in LABELS]
    assert [len(p.events) for p in tr.parts] == [2, 2, 0, 1]
    assert tr.parts[0].span_s == pytest.approx(2000e-9)
    assert tr.parts[0].busy_s == pytest.approx(1500e-9)
    assert tr.busy_s == pytest.approx((1000 + 500 + 500 + 400 + 500) * 1e-9)


def test_split_refuses_a_short_session():
    assert split(session()[:4], M, LABELS, 1.0) is None


def test_idle_gaps_by_what_the_host_did():
    tr = split(session(), M, LABELS, window_s=10e-6)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["prefill_64: between ops"] == pytest.approx(500e-9)
    assert gaps["decode_step: before its first op"] == pytest.approx(2000e-9)
    assert gaps["decode_step: between ops"] == pytest.approx(100e-9)
    assert gaps["waiting for arrivals"] == pytest.approx(2000e-9)
    ops = dict((k, v) for k, v in tr.top_ops())
    assert ops["gemm"] == pytest.approx(1500e-9)


def test_readers_on_a_trace():
    tr = split(session(), M, LABELS, window_s=10e-6)
    run = RunView(cell=None, shape=S, trace=tr, result=None)
    assert idle_percent(run) == pytest.approx(100 * (1 - 2900e-9 / 10e-6))
    got = mfu_percent(run, "prefill", lambda s, i: 989e12 * 1e-9)
    # two prefills of 1 ns of work each over 2000 + 500 ns on the device
    assert got == pytest.approx(100 * 2e-9 / 2500e-9)
    assert mfu_percent(run, "train", lambda s, i: 1.0) is None
    assert idle_percent(RunView(None, S, None, None)) is None
    # the decode step's busy time: 500 + 400 ns in its one step
    busy = R._reader("decode_busy_ms.longgen")
    assert busy(run) == pytest.approx(900e-9 * 1e3)
    assert busy(RunView(None, S, None, None)) is None
