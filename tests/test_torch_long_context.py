"""Long contexts in the port on the CPU: what the card's 32k-token paths
and their checks rest on.

- Rotary embeddings at positions 0, 8191, 8192 and 32767 for theta 500000
  (llama3-8b) and 1e6 (codellama2-34b, qwen2-72b) against the reference's
  ``apply_rope``: both compute in f32 and part only where one of the 64
  frequencies rounds one ulp apart (theta 1e6, frequency 37: the two
  packages' pow), which position 32767 turns into 2.3e-6 of the output.
- llama3-8b-sw's smoke config (window 64) in the port's ``ServingEngine``
  against the JAX engine: prompts longer than the window (the prefill rolls
  the ring), and decode that wraps the ring more than twice.
- ``split_rows`` at the card's long caches.
- ``flash_prefill_plain_chunked`` (the plain version that ``chip_smoke.py``
  holds the 32768-position prefills against, query rows a chunk at a time)
  against the unchunked plain version, and its gradient
  ``flash_prefill_bwd_plain_chunked`` (llama4-scout's T 16384 backward row)
  against autograd of the unchunked one.
- The bf16 prefill kernel's rounding at long causal rows: its algorithm
  emulated (64-key tiles, p rounded to bf16 against the running row max),
  held as ``chip_smoke.py`` holds the long bf16 prefills, to the f32
  attention of the same inputs, no less accurate than the plain version.
"""
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
torch.exp(torch.zeros(64))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

POSITIONS = [0, 8191, 8192, 32767]
# f32 rotary: 1e-5, four times the 2.3e-6 that one frequency's ulp makes
# at position 32767 (theta 1e6); equal elsewhere to a few f32 ulps
ROPE_ATOL = 1e-5
# chip_smoke.py's TOL["bfloat16"] and BF16_EXACT_SHARE_RATIO
BF16_ATOL_RMS, BF16_RTOL, EXACT_SHARE_RATIO = 1e-2, 2.0 ** -6, 1.1


@pytest.mark.parametrize("arch,theta", [("llama3-8b", 500_000.0),
                                        ("codellama2-34b", 1_000_000.0),
                                        ("qwen2-72b", 1_000_000.0)])
def test_apply_rope_at_long_positions_matches_jax(arch, theta):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.rope_theta == theta
    hd = cfg.head_dim
    np.testing.assert_array_max_ulp(
        L._rope_freqs(theta, hd // 2, "cpu").numpy(),
        np.asarray(JL._rope_freqs(hd, theta, hd // 2)), maxulp=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, len(POSITIONS), 4, hd)).astype("float32")
    pos = np.array([POSITIONS, POSITIONS[::-1]], dtype=np.int32)
    want = np.asarray(JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos)))
    got = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ROPE_ATOL, rtol=0)
    # position 0 turns nothing
    np.testing.assert_array_equal(got.numpy()[0, 0], x[0, 0])


def test_sliding_window_engine_wraps_ring_matches_jax():
    """llama3-8b-sw's smoke config (64-row window): two prompts longer than
    the window, the second joining mid-flight, and 150 tokens each, so
    decode wraps the ring more than twice; tokens equal to the JAX
    engine's on its weights."""
    jcfg, cfg = jax_smoke_config("llama3-8b-sw"), get_smoke_config(
        "llama3-8b-sw")
    assert cfg.sliding_window == 64 and jcfg.sliding_window == 64
    econf = dict(max_batch=2, max_seq_len=320, eos_token=-1)
    je = jeng.ServingEngine(jcfg, seed=4, econf=jeng.EngineConfig(**econf))
    te = ServingEngine(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, je.params), cfg, device="cpu"),
        econf=EngineConfig(**econf, device="cpu"))
    assert te.cache["local_k"].shape[2] == 64
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size - 1, n).tolist()
               for n in (100, 150)]
    out = []
    for make, eng in ((JRequest, je), (Request, te)):
        r1, r2 = (make(rid=i, arrival_time=0.0, prompt_len=len(p),
                       output_len=150, prompt_tokens=p)
                  for i, p in enumerate(prompts))
        eng.prefill(r1)
        for _ in range(7):
            eng.decode_step()
        eng.prefill(r2)
        while eng.decode_step():
            pass
        out.append((r1.generated, r2.generated))
    assert out[0] == out[1]
    assert [len(g) for g in out[1]] == [150, 150]


@pytest.mark.parametrize("B,Hkv,S,rows", [
    (1, 8, 32768, 512),        # 64 splits a sequence
    (8, 8, 32768, 3712),       # the 32k decode row: 9 splits
    (8, 52, 8192, 4096),       # llama-30b: 2 splits
    (8, 8, 8192, 1024),        # the paper's G 8 models: 8 splits
    (2, 8, 32832, 1024)])      # the 32k engine: 33 splits
def test_split_rows_at_long_caches(B, Hkv, S, rows):
    got = DA.split_rows(B, Hkv, S, 132)
    assert got == rows and got % DA.SPLIT_QUANTUM == 0
    n_split = -(-S // got)
    # the first pass's blocks (splits x kv heads x batch) fill the SMs
    assert n_split * Hkv * B >= 132


CHUNK_CASES = [  # T, S, Hq, Hkv, causal, window, q_offset
    (300, 300, 4, 2, True, 0, 0),
    (300, 300, 4, 2, True, 70, 0),
    (200, 300, 4, 1, True, 0, 100),       # a chunked prefill past 100 keys
    (150, 300, 4, 1, True, 40, 150),
    (257, 257, 2, 2, False, 50, 0),       # bidirectional, one-sided window
    (257, 200, 2, 1, False, 0, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CHUNK_CASES,
                         ids=[f"T{c[0]}-S{c[1]}-c{int(c[4])}-w{c[5]}-o{c[6]}"
                              for c in CHUNK_CASES])
def test_chunked_plain_equals_unchunked(case, dtype):
    """Each chunk's rows see the same opened keys as in the whole matrix,
    so the maxima, sums and outputs agree to f32 rounding (the sums run
    over the opened keys only, so their order differs); bf16 outputs are
    equal or one bf16 step apart where that rounding meets a rounding
    boundary.  The log-sum-exp agrees to f32 rounding, -inf where a row
    has no key on both sides."""
    T, S, Hq, Hkv, causal, window, off = case
    rng = np.random.default_rng(T + S + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, n, h, 64), "float32")).to(dtype)
        for n, h in ((T, Hq), (S, Hkv), (S, Hkv)))
    kw = dict(causal=causal, window=window, q_offset=off)
    want, want_lse = FP.flash_prefill_plain(q, k, v, **kw, return_lse=True)
    got, lse = FP.flash_prefill_plain_chunked(q, k, v, **kw, rows=64,
                                              return_lse=True)
    assert got.shape == want.shape and got.dtype == want.dtype
    step = 0.0 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=1e-6, rtol=1e-6 + step)
    if dtype == torch.bfloat16:
        assert (got == want).float().mean() > 0.99
    np.testing.assert_array_equal(torch.isinf(lse).numpy(),
                                  torch.isinf(want_lse).numpy())
    fin = torch.isfinite(want_lse)
    np.testing.assert_allclose(lse[fin].numpy(), want_lse[fin].numpy(),
                               atol=1e-5, rtol=0)


BWD_CHUNK_CASES = [  # T, S, Hq, Hkv, causal, window
    (300, 300, 4, 2, True, 0),
    (300, 300, 10, 2, True, 70),          # llama4-scout's G 5 under a window
    (257, 257, 2, 2, False, 50),          # bidirectional, one-sided window
    (257, 200, 2, 1, False, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CHUNK_CASES,
                         ids=[f"T{c[0]}-S{c[1]}-G{c[2] // c[3]}-c{int(c[4])}"
                              f"-w{c[5]}" for c in BWD_CHUNK_CASES])
def test_chunked_plain_gradient_equals_unchunked(case, dtype):
    """``flash_prefill_bwd_plain_chunked`` (the plain gradient that
    ``chip_smoke.py`` holds the backward kernel to at T 16384) against
    autograd of the unchunked plain version: each row's dQ from its own
    chunk, dK and dV summed over the chunks in f32 and rounded once, so the
    two agree to f32 rounding; in bf16 equal or one bf16 step apart where
    that rounding meets a rounding boundary."""
    T, S, Hq, Hkv, causal, window = case
    rng = np.random.default_rng(T + S + window + Hq)
    q, do = (torch.from_numpy(rng.standard_normal(
        (1, T, Hq, 64), "float32")).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (1, S, Hkv, 64), "float32")).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    want = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
    got = FP.flash_prefill_bwd_plain_chunked(q, k, v, do, **kw, rows=64)
    # (one bf16 step is 2^-7 of a value at the bottom of its binade)
    step = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        scale = float(w.float().abs().max())
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   atol=1e-6 * scale, rtol=1e-5 + step)
        if dtype == torch.bfloat16:
            assert (g == w).float().mean() > 0.99


def emulate_bf16_prefill(q, k, v, causal=True, window=0, bk=64):
    """The bf16 ``flash_prefill`` kernel's algorithm (csrc/flash_prefill.cu,
    namespace ``tc``) in plain PyTorch for MHA inputs: f32 scores over
    ``bk``-key tiles in order, a running row max, p = exp(s - running max)
    rounded to bf16 before P.V, the accumulator and the row sum rescaled by
    exp(old max - new max), the output divided by the sum and rounded to
    bf16."""
    T, S, H, D = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    qf, kf, vf = (x[0].float().transpose(0, 1) for x in (q, k, v))
    m = torch.full((H, T, 1), float("-inf"))
    l, o = torch.zeros((H, T, 1)), torch.zeros((H, T, D))
    qp = torch.arange(T)[:, None]
    for k0 in range(0, S, bk):
        kp = torch.arange(k0, min(S, k0 + bk))[None, :]
        s = qf @ kf[:, k0:k0 + bk].transpose(-1, -2) * D ** -0.5
        ok = torch.ones((T, kp.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= kp > qp - window
        s = s.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp(m - m_safe)
        p = torch.exp(s - m_safe)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = alpha * o + p.bfloat16().float() @ vf[:, k0:k0 + bk]
        m = m_new
    return (o / torch.where(l > 0, l, 1.0)).transpose(0, 1)[None].bfloat16()


def bf16_share(got, want):
    """chip_smoke.compare's largest share of the bf16 limit."""
    want = want.float()
    diff = (got.float() - want).abs()
    limit = BF16_ATOL_RMS * want.square().mean().sqrt() + BF16_RTOL * \
        want.abs()
    return float(torch.where(diff == 0, 0.0, diff / limit).max())


@pytest.mark.parametrize("window", [0, 1024])
def test_bf16_prefill_rounding_held_to_f32_attention(window):
    """At T = S = 4096 (2 heads) the emulated kernel sits as close to the
    f32 attention as the plain version does (within chip_smoke.py's ratio
    of 1.1), while against the plain version, whose p is rounded against
    the final row max instead of the running one, its worst element is
    printed: 1.05 of the two-step limit causal and 1.18 under the window,
    past the limit that T 1024 keeps (0.82 emulated; 0.74-0.88 on the
    card)."""
    rng = np.random.default_rng(window + 3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 4096, 2, 128), "float32")).bfloat16() for _ in range(3))
    kw = dict(causal=True, window=window)
    got = emulate_bf16_prefill(q, k, v, **kw)
    plain = FP.flash_prefill_plain_chunked(q, k, v, **kw, rows=1024)
    exact = FP.flash_prefill_plain_chunked(q.float(), k.float(), v.float(),
                                           **kw, rows=1024)
    s_got, s_plain = bf16_share(got, exact), bf16_share(plain, exact)
    print(f"window {window}: against the plain version "
          f"{bf16_share(got, plain):.3f}; against f32: emulated kernel "
          f"{s_got:.3f}, plain {s_plain:.3f}")
    assert torch.isfinite(got.float()).all()
    assert s_got <= EXACT_SHARE_RATIO * s_plain
    # the first 64 rows see one key tile: there the running max is the
    # final one, and the emulation is the plain version to f32 rounding
    np.testing.assert_allclose(got[:, :64].float().numpy(),
                               plain[:, :64].float().numpy(), atol=0,
                               rtol=2.0 ** -8)
