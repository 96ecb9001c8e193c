"""The operation and byte counts against sums written out by hand."""
from harness.spec import Shape
from harness.work import (attention_bytes, attention_ops, decode_flops,
                          nonembed_params, prefill_flops, roofline_seconds,
                          train_flops)

S = Shape(name="t", n_layers=2, d_model=8, n_heads=4, n_kv_heads=2,
          head_dim=2, d_ff=16, vocab=10, qk_norm=False, rope_theta=1e4,
          norm_eps=1e-6, dtype="bfloat16")


def test_nonembed_params():
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8, w1 8x16, w3 8x16, w2 16x8 a layer
    per_layer = 64 + 32 + 32 + 64 + 128 + 128 + 128
    assert nonembed_params(S) == 2 * per_layer


def test_attention_counts():
    # T = 3: pairs (0,0), (1,0), (1,1), (2,0), (2,1), (2,2) = 6 a head;
    # scores and weighted values: 2 products of 2 x head_dim operations
    assert attention_ops(S, 1, 3) == 4 * 4 * 2 * 6
    # q and o: 4 heads, k and v: 2 heads; 3 positions, 2 wide, 2 bytes
    assert attention_bytes(S, 1, 3) == 2 * 3 * 2 * (4 + 4 + 2 + 2)


def test_prefill_decode_train():
    n = nonembed_params(S)
    assert prefill_flops(S, 2, 3) == (2 * n * 6 + 2 * attention_ops(S, 2, 3)
                                      + 2 * 2 * 8 * 10)
    # one token each of 2 sequences over 5 valid positions
    assert decode_flops(S, 2, 5) == (2 * n * 2 + 2 * 4 * 2 * 4 * 2 * 5
                                     + 2 * 2 * 8 * 10)
    fwd = 2 * n * 6 + 2 * attention_ops(S, 2, 3) + 2 * 6 * 8 * 10
    assert train_flops(S, 2, 3) == 3 * fwd


def test_roofline_picks_the_larger_bound():
    t, by = roofline_seconds(989e12, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = roofline_seconds(1.0, 3.35e12)
    assert (t, by) == (1.0, "bytes")
