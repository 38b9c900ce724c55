"""FLOP and byte counts against a hand count at one shape of each
architecture."""

import pytest

from bench.cell import load_cell
from bench.flops import module, step_flops
from bench.peaks import attention_bound_s, visible_pairs


def test_visible_pairs():
    assert visible_pairs(4, 4, True) == 10
    assert visible_pairs(4, 4, False) == 16
    assert visible_pairs(5, 5, True, window=2) == 9
    assert visible_pairs(4096, 4096, True) == 4096 * 4097 // 2


def test_qwen2_hand_count():
    conf = load_cell("qwen2-1.5b.pack4k").conf
    d, ff, V, L = 1536, 8960, 151936, 28
    # q 1536x1536, k and v 1536x256, o 1536x1536, biases 1536 + 2 x 256,
    # three MLP matrices, two norms; the tied head once, the final norm
    block = (1536 * 1536 * 2 + 1536 * 256 * 2 + 1536 + 512
             + 3 * d * ff + 2 * d)
    assert module("qwen2").active_params(conf) == L * block + d * V + d
    traffic = {"rows": 2, "context": 4096}
    attn = 6 * (4096 * 4097 // 2) * 256 * 12 * 28 * 2
    assert step_flops(conf, traffic) == pytest.approx(
        6 * (L * block + d * V + d) * 8192 + attn)


def test_attention_bound():
    # (1, 12, 4096, 128) causal fp32: operations bound it
    flops = 2 * 12 * 256 * (4096 * 4097 // 2)
    assert attention_bound_s((1, 12, 4096, 128), (1, 2, 4096, 128),
                             (1, 2, 4096, 128), True, None, "float32") \
        == pytest.approx(flops / 67e12)
    # (1, 1, 128, 64) bf16 non-causal, a window: bytes of q, k, v, o
    nbytes = 2 * 4 * 128 * 64
    assert attention_bound_s((1, 1, 128, 64), (1, 1, 128, 64),
                             (1, 1, 128, 64), False, None, "bfloat16") \
        == pytest.approx(max(2 * 128 * 128 * 128 / 989e12,
                             nbytes / 3.35e12))
