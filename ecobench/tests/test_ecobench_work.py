"""FLOP and byte counts against counts by hand."""
from ecobench_testlib import REPO  # noqa: F401  (puts the repo on the path)
from ecobench.harness import work
from ecobench.harness.model import load_config, model_of


def test_qwen2_72b_layer_params():
    m = model_of(load_config("qwen2-72b"))
    # q 8192x8192, k and v 8192x1024 each, o 8192x8192, SwiGLU 3 x 8192 x 29568
    assert m.layer_matmul_params() == (2 * 8192 * 8192 + 2 * 8192 * 1024
                                       + 3 * 8192 * 29568)


def test_qwen2_72b_prefill_flops_by_hand():
    m = model_of(load_config("qwen2-72b"))
    T = 2000
    per_layer = 2 * (2 * 8192 * 8192 + 2 * 8192 * 1024 + 3 * 8192 * 29568) * T
    attn = 4 * 128 * 64 * (T * (T + 1) // 2)
    head = 2 * 8192 * 152064
    assert work.prefill_flops(m, T) == 8 * (per_layer + attn) + head


def test_decode_flops_by_hand():
    m = model_of(load_config("qwen2-72b"))
    b, ctx = 3, 1000 + 2000 + 10
    want = (8 * 2 * m.layer_matmul_params() * b
            + 8 * 4 * 128 * 64 * (ctx + b) + 2 * 8192 * 152064 * b)
    assert work.decode_flops(m, b, ctx) == want


def test_flash_prefill_work():
    f, nb = work.flash_prefill_work(1, 4, 4, 8, 2, 128, 2)
    assert f == 4 * 128 * 8 * 10            # 10 causal pairs of 4 rows
    assert nb == 2 * (2 * 4 * 8 * 128 + 2 * 4 * 2 * 128)
    f, _ = work.flash_prefill_work(1, 2, 5, 1, 1, 64, 2, q_offset=3)
    assert f == 4 * 64 * (4 + 5)            # rows see 4 and 5 keys


def test_decode_attention_work_and_bound():
    f, nb = work.decode_attention_work(2, 64, 8, 128, 3000, 2)
    assert f == 4 * 128 * 64 * 3000
    assert nb == 2 * (2 * 3000 * 8 * 128 + 2 * 2 * 64 * 128)
    assert work.bound_s(f, nb) == nb / 3.35e12     # bytes bound it
    assert work.bound_s(989e12, 1.0) == 1.0
