"""The traffic's fixed composition and its draws from the seed."""
from collections import Counter

import numpy as np

from harness.spec import load_cell
from harness.traffic import (closed_wave, open_schedule, prompt_ids,
                             train_rows)

BIG = 2**31 + 987_654_321


def test_open_loop_composition_fixed_across_seeds():
    t = load_cell("qwen3-14b.docqa").traffic
    seconds = 40
    runs = [open_schedule(t, seed, seconds) for seed in (0, 1, BIG, 2**40)]
    n = len(runs[0])
    assert n == int(np.ceil(t["rate_per_s"] * seconds))
    for reqs in runs:
        assert len(reqs) == n
        assert [r.due for r in reqs] == [i / t["rate_per_s"]
                                         for i in range(n)]
        # every block of six holds each length once
        lengths = [r.length for r in reqs]
        k = len(t["prompt_lengths"])
        for a in range(0, n - n % k, k):
            assert sorted(lengths[a:a + k]) == sorted(t["prompt_lengths"])
        assert Counter(lengths) == Counter(r.length for r in runs[0])
    orders = {tuple(r.length for r in reqs) for reqs in runs}
    assert len(orders) > 1                      # the seed changes the order


def test_prompts_from_the_seed():
    a = prompt_ids(BIG, 5, 2048, 151936)
    assert a.shape == (2048,) and a.min() >= 0 and a.max() < 151936
    assert np.array_equal(a, prompt_ids(BIG, 5, 2048, 151936))
    assert not np.array_equal(a, prompt_ids(BIG + 1, 5, 2048, 151936))


def test_closed_waves_equal():
    t = load_cell("qwen3-14b.longgen").traffic
    idx, p = closed_wave(t, BIG, 1, 151936)
    assert p.shape == (t["wave_size"], t["prompt_lengths"][0])
    assert idx == list(range(t["wave_size"], 2 * t["wave_size"]))


def test_train_rows_differ_and_repeat():
    t = load_cell("internlm2-1.8b.pretrain-4k").traffic
    b = train_rows(t, BIG, 3, 92544)
    assert b["tokens"].shape == (t["global_batch"], t["seq_len"])
    assert np.array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert len({row.tobytes() for row in b["tokens"]}) == t["global_batch"]
    assert np.array_equal(b["tokens"], train_rows(t, BIG, 3, 92544)["tokens"])
    assert not np.array_equal(b["tokens"],
                              train_rows(t, BIG, 4, 92544)["tokens"])
