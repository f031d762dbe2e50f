"""The port's attention kernels on the CPU: each wrapper's plain PyTorch
version against the JAX package's Pallas kernel run in interpret mode, on
the inputs of ``tests/test_kernels.py`` (made with numpy from a seed), the
plain form of the decode kernel's split-S algorithm against both, the
split-count rule, plus the wrappers' dispatch and input checks.  The
backward of ``flash_prefill``: its kernel's algorithm in plain PyTorch
against autograd of the plain forward, and ``FlashPrefillFn``'s wiring.
The CUDA kernels themselves run only on the card (``chip_smoke.py``)."""
import contextlib
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
# The first torch.exp of a CPU process with 2 intra-op threads can come out
# less accurate on part of its tensor (torch 2.13; a second call on the
# same input is exact to f32): one call here, before any comparison, so
# that the f32 checks below see the port's arithmetic (ROADMAP Queue 3).
# The call runs when pytest collects this module, so it warms every worker
# process that collects it, and with it whatever tests of other modules that
# process runs afterwards; a process that does not collect this module is
# not covered.
torch.exp(torch.zeros(64))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jax_flash  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels.ops import decode_attention_op, flash_prefill_op  # noqa: E402

# |port - pallas| <= atol + atol_rms * rms(pallas) + rtol * |pallas|.
# Both round p to the input dtype before P.V, so f32 differs only in the
# order of sums; bf16 also in the one rounding of the output (one bf16
# step, at most 2**-7 of |pallas|) and in where p meets its rounding
# (Pallas rounds against a running row max; up to another step on rows
# with few keys).  chip_smoke.py holds the kernels to the same limits.
TOL = {"float32": dict(atol=2e-5, atol_rms=0.0, rtol=2e-5),
       "bfloat16": dict(atol=0.0, atol_rms=1e-2, rtol=2.0 ** -6)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU torch tensor of ``dtype``
    (both round f32 to bf16 to nearest even)."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(tdt))


def _close(got, want, dtype: str, err_msg: str = "") -> None:
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    want = np.asarray(want, np.float64)
    tol = TOL[dtype]
    atol = tol["atol"] + tol["atol_rms"] * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=tol["rtol"], atol=atol, err_msg=err_msg)


@contextlib.contextmanager
def _ieee_f32_matmuls():
    """Full-precision f32 products on both sides: JAX's default matmul
    precision "highest", torch's f32 matmul precision "highest" and, where
    this torch has it, oneDNN's f32 matmul precision "ieee" (a CPU with
    bf16 or AMX units may otherwise be allowed reduced-precision products).
    Both are restored afterwards."""
    prev = torch.get_float32_matmul_precision()
    mkl = getattr(torch.backends.mkldnn, "matmul", None)
    prev_mkl = getattr(mkl, "fp32_precision", None)
    torch.set_float32_matmul_precision("highest")
    if prev_mkl is not None:
        mkl.fp32_precision = "ieee"
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)   # (this resets oneDNN's)
        if prev_mkl is not None:
            mkl.fp32_precision = prev_mkl


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (nearest even) and widened to f64."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def _flash_oracle(q, k, v, dtype, causal=True, window=0, q_offset=0):
    """float64 numpy attention on the inputs as the kernels see them (the
    torch tensors, already in ``dtype``), with p rounded to bf16 before P.V
    when the inputs are bf16, as the kernels do."""
    q, k, v = (x.double().numpy() for x in (q, k, v))
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    s = np.einsum("bqhgd,bshd->bhgqs", q.reshape(B, T, Hkv, G, D),
                  k) * D ** -0.5
    qp = q_offset + np.arange(T)[:, None]
    kp = np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdims=True)
    if dtype == "bfloat16":
        p = _round_bf16(p)
    o = np.einsum("bhgqs,bshd->bhgqd", p, v) / np.where(l > 0, l, 1.0)
    return o.transpose(0, 3, 1, 2, 4).reshape(B, T, Hq, D)


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64),       # MHA square
    (2, 128, 128, 8, 2, 64),       # GQA 4:1
    (1, 96, 96, 4, 1, 128),        # MQA, non-multiple T
    (2, 256, 256, 10, 2, 128),     # G=5 odd grouping
    (1, 80, 80, 10, 1, 256),       # recurrentgemma-2b: G=10, D=256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_plain_matches_pallas(B, T, S, Hq, Hkv, D, dtype):
    """Each side against a float64 oracle of the same inputs first, so that
    a failure names the side that drifted, then the two against each
    other; f32 products at full precision on both sides."""
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng.normal(size=(B, T, Hq, D)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)).astype(np.float32), dtype)
    with _ieee_f32_matmuls():
        want = np.asarray(jax_flash(qj, kj, vj, causal=True, block_q=64,
                                    block_k=64, interpret=True), np.float32)
        got = FP.flash_prefill(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    oracle = _flash_oracle(qt, kt, vt, dtype)
    _close(want, oracle, dtype, "the Pallas interpret run drifted from the "
           "float64 oracle")
    _close(got, oracle, dtype, "the port's plain version drifted from the "
           "float64 oracle")
    _close(got, want, dtype)


@pytest.mark.parametrize("causal,window,q_offset,T,S", [
    (True, 32, 0, 160, 160),       # sliding window
    (True, 64, 0, 160, 160),
    (True, 0, 128, 64, 192),       # chunked prefill: q at an offset
    (False, 0, 0, 128, 128),       # bidirectional (encoder)
])
def test_flash_prefill_plain_masks_match_pallas(causal, window, q_offset,
                                                T, S):
    rng = np.random.default_rng(7)
    Hq, Hkv, D = 4, 2, 64
    qj, qt = _pair(rng.normal(size=(1, T, Hq, D)).astype(np.float32),
                   "float32")
    kj, kt = _pair(rng.normal(size=(1, S, Hkv, D)).astype(np.float32),
                   "float32")
    vj, vt = _pair(rng.normal(size=(1, S, Hkv, D)).astype(np.float32),
                   "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jax_flash(qj, kj, vj, block_q=32, block_k=64, interpret=True,
                     **kw)
    _close(flash_prefill_op(qt, kt, vt, **kw), want, "float32")


@pytest.mark.parametrize("B,S,Hq,Hkv,D,block_s", [
    (2, 256, 8, 2, 64, 64),
    (4, 1000, 4, 4, 128, 256),     # ragged, non-multiple S
    (1, 512, 10, 2, 64, 128),
    (2, 300, 10, 1, 256, 128),     # recurrentgemma-2b: G=10, D=256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(B, S, Hq, Hkv, D, block_s,
                                               dtype):
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng.normal(size=(B, Hq, D)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)).astype(np.float32), dtype)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), block_s=block_s,
                      interpret=True)
    got = decode_attention_op(qt, kt, vt, torch.from_numpy(lengths))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


def test_empty_rows_are_zero():
    """No valid key: the plain versions return zeros, as
    ``repro.kernels.ref`` does (the engine never asks for such a row)."""
    q = torch.ones(2, 3, 4, 64)
    k = v = torch.ones(2, 5, 2, 64)
    out = FP.flash_prefill(q, k, v, causal=True, window=2, q_offset=10)
    assert torch.equal(out, torch.zeros_like(out))
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    out = DA.decode_attention(q[:, 0], k, v, lengths)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.all(out[1] == 1.0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q = torch.randn(1, 8, 4, 64)
    k = v = torch.randn(1, 8, 2, 64)
    n_fp, n_da = FP.flash_prefill.launches, DA.decode_attention.launches
    assert torch.equal(FP.flash_prefill(q, k, v),
                       FP.flash_prefill_plain(q, k, v))
    lengths = torch.tensor([8], dtype=torch.int32)
    assert torch.equal(DA.decode_attention(q[:, 0], k, v, lengths),
                       DA.decode_attention_plain(q[:, 0], k, v, lengths))
    assert (FP.flash_prefill.launches, DA.decode_attention.launches) == (
        n_fp, n_da)


def _grad_calls():
    """name -> (wrapper call on fresh CPU inputs that require grad, the
    inputs)."""
    from repro_torch.kernels import rglru_scan as RG
    from repro_torch.kernels import rwkv6_scan as RS
    g = torch.Generator().manual_seed(0)

    def leaf(*shape, scale=1.0, lo=None):
        x = torch.randn(shape, generator=g) * scale
        if lo is not None:                     # decays in (lo, 1)
            x = lo + (1 - lo) * torch.sigmoid(x)
        return x.requires_grad_()

    fp = (leaf(1, 9, 4, 64), leaf(1, 9, 2, 64), leaf(1, 9, 2, 64))
    da = (leaf(2, 4, 64), leaf(2, 7, 2, 64), leaf(2, 7, 2, 64))
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    rs = (leaf(1, 5, 2, 64, scale=0.5), leaf(1, 5, 2, 64, scale=0.5),
          leaf(1, 5, 2, 64, scale=0.5), leaf(1, 5, 2, 64, lo=0.6),
          leaf(2, 64, scale=0.1))
    rg = ((-leaf(1, 6, 8).detach().abs()).requires_grad_(), leaf(1, 6, 8),
          leaf(1, 8))
    return {"flash_prefill": (lambda: FP.flash_prefill(*fp), fp),
            "decode_attention": (lambda: DA.decode_attention(*da, lengths),
                                 da),
            "rwkv6_scan": (lambda: RS.rwkv6_scan(*rs)[0], rs),
            "rglru_scan": (lambda: RG.rglru_scan(*rg), rg)}


@pytest.mark.parametrize("name", ["flash_prefill", "decode_attention",
                                  "rwkv6_scan", "rglru_scan"])
def test_plain_paths_carry_gradients(name):
    """On CPU tensors each wrapper runs its plain version, which autograd
    records: every input that requires grad gets a finite, non-zero
    gradient.  (On CUDA tensors flash_prefill in f32 and the scans go
    through their backward kernels, and decode_attention refuses such
    inputs; chip_smoke.py checks both on the card.)"""
    call, inputs = _grad_calls()[name]
    out = call()
    assert out.grad_fn is not None
    out.square().sum().backward()
    for x in inputs:
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert float(x.grad.abs().sum()) > 0


def test_refuse_grad_raises_only_where_autograd_would_record():
    """The wrappers of kernels without a backward for their inputs
    (decode_attention; flash_prefill where ``no_backward_reason`` gives
    one; rwkv6_scan outside ``BWD_HEAD_DIMS``) raise through this on CUDA
    inputs, only where autograd would record the call; flash_prefill's
    backward kernel covers f32 at D 64 / 80 / 128 / 256 and bf16 at D 64 /
    128 / 256, without a q_offset, and nothing else."""
    from repro_torch.kernels import _build
    x, y = torch.zeros(3, requires_grad=True), torch.zeros(3)
    with pytest.raises(RuntimeError, match="no backward for bf16"):
        _build.refuse_grad("k", y, x, None, why=" for bf16")
    assert _build.wants_grad(y, x) and not _build.wants_grad(y, None)
    _build.refuse_grad("k", y, None)
    with torch.no_grad():
        assert not _build.wants_grad(y, x)
        _build.refuse_grad("k", y, x)
    for D in (64, 80, 128, 256):
        assert FP.no_backward_reason(torch.float32, D, 0) == ""
    for D in (64, 128, 256):
        assert FP.no_backward_reason(torch.bfloat16, D, 0) == ""
    assert FP.no_backward_reason(torch.bfloat16, 80, 0)
    assert FP.no_backward_reason(torch.float16, 128, 0)
    assert FP.no_backward_reason(torch.float32, 96, 0)
    assert FP.no_backward_reason(torch.float32, 128, 64)


def test_wrappers_reject_malformed_inputs():
    q = torch.randn(1, 8, 6, 64)
    k = torch.randn(1, 8, 4, 64)            # 6 query heads over 4 kv heads
    with pytest.raises(ValueError):
        FP.flash_prefill(q, k, k)
    with pytest.raises(ValueError):
        DA.decode_attention(q[:, 0], k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):         # lengths of the wrong shape
        DA.decode_attention(torch.randn(2, 4, 64), torch.randn(2, 8, 2, 64),
                            torch.randn(2, 8, 2, 64),
                            torch.ones(3, dtype=torch.int32))


# --------------------------------------------------------------------- #
# split-S decode: the kernel's two passes in plain PyTorch
# --------------------------------------------------------------------- #
def _decode_inputs(rng, B, S, Hq, Hkv, D, dtype):
    return tuple(_pair(rng.normal(size=shape).astype(np.float32), dtype)
                 for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,block_s", [
    (2, 256, 8, 2, 64, 64),
    (4, 1000, 4, 4, 128, 256),     # ragged, non-multiple S
    (1, 512, 10, 2, 64, 128),
    (2, 300, 10, 1, 256, 128),     # recurrentgemma-2b: G=10, D=256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_plain_matches_pallas(B, S, Hq, Hkv, D, block_s,
                                           dtype):
    """The ragged shapes of ``test_decode_attention_plain_matches_pallas``
    at the split size the kernel takes on a 132-SM card."""
    rng = np.random.default_rng(42)
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, S, Hq, Hkv, D,
                                                  dtype)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    rows = DA.split_rows(B, Hkv, S, 132)
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), block_s=block_s,
                      interpret=True)
    got = DA.decode_attention_split_plain(qt, kt, vt,
                                          torch.from_numpy(lengths), rows)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("lengths", [
    [1, 1],                        # one key: every split but the first empty
    [128, 256],                    # on a split boundary
    [127, 257],                    # one short of / one past a boundary
    [129, 255],
    [300, 1],                      # S, not a multiple of the split size
    [2, 299],
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_plain_edges_match_pallas(lengths, dtype):
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 300, 10, 1, 256   # splits of 128: 128, 128, 44
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, S, Hq, Hkv, D,
                                                  dtype)
    ln = np.asarray(lengths, np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(ln), block_s=128,
                      interpret=True)
    got = DA.decode_attention_split_plain(qt, kt, vt, torch.from_numpy(ln),
                                          128)
    _close(got, want, dtype)


def test_decode_split_plain_empty_sequence_is_zero():
    """Length 0: every split is empty, none adds a NaN, the row is 0; the
    other sequence matches the unsplit plain version."""
    rng = np.random.default_rng(5)
    (_, q), (_, k), (_, v) = _decode_inputs(rng, 2, 200, 4, 2, 64,
                                            "float32")
    lengths = torch.tensor([0, 150], dtype=torch.int32)
    got = DA.decode_attention_split_plain(q, k, v, lengths, 64)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1], DA.decode_attention_plain(q, k, v, lengths)[1].numpy(),
           "float32")


@settings(max_examples=25)
@given(B=st.integers(1, 3), S=st.integers(1, 400), Hkv=st.sampled_from([1, 2]),
       G=st.sampled_from([1, 4, 10]), rows=st.integers(1, 8),
       data=st.data())
def test_decode_split_result_does_not_depend_on_the_split_count(
        B, S, Hkv, G, rows, data):
    """Any split size (a multiple of 128, as the kernel takes, or not)
    gives the unsplit softmax in f32, within the f32 limit."""
    rows = rows * 128 if data.draw(st.booleans()) else rows * 37
    lengths = data.draw(st.lists(st.integers(0, S), min_size=B, max_size=B))
    rng = np.random.default_rng(S * 31 + rows)
    (_, q), (_, k), (_, v) = _decode_inputs(rng, B, S, G * Hkv, Hkv, 64,
                                            "float32")
    ln = torch.tensor(lengths, dtype=torch.int32)
    want = DA.decode_attention_plain(q, k, v, ln)
    _close(DA.decode_attention_split_plain(q, k, v, ln, rows), want.numpy(),
           "float32")


@pytest.mark.parametrize("B,Hkv,S,rows,n_split", [
    (8, 1, 2048, 128, 16),         # recurrentgemma-2b's decode
    (8, 8, 2048, 256, 8),          # llama3-8b's decode
    (1, 1, 2048, 128, 16),         # one sequence: the most splits
    (64, 8, 2048, 1024, 2),        # 512 (kv head, batch) blocks already
    (128, 8, 2048, 2048, 1),
    (8, 8, 100, 128, 1),           # S under one split
])
def test_split_rows_at_the_served_shapes(B, Hkv, S, rows, n_split):
    got = DA.split_rows(B, Hkv, S, 132)
    assert (got, -(-S // got)) == (rows, n_split)
    assert got % DA.SPLIT_QUANTUM == 0


# --------------------------------------------------------------------- #
# flash_prefill's backward: the kernel's algorithm in plain PyTorch
# --------------------------------------------------------------------- #
# |tiled - autograd| <= 1e-5 * max|autograd| per gradient: both are f32
# sums of the same products in another order (the kernel's tiles, its
# dK/dV split over q-tile ranges, P recomputed from the log-sum-exp rather
# than normalised by l)
BWD_RTOL = 1e-5


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 24)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (10, 1)])
@pytest.mark.parametrize("D", [64, 80, 256])
def test_flash_prefill_bwd_tiled_plain_matches_autograd(causal, window, Hq,
                                                        Hkv, D):
    """T and S off the kernel's tiles (``bwd_tiles``; T*G rows as the
    kernel flattens them, G 1 / 4 / 10), the dK/dV launch split over 4
    q-tile ranges at these sizes; at S < T under a window, rows with no
    valid key (log-sum-exp -inf) get zero gradients."""
    rng = np.random.default_rng(3)
    B, T, S = 2, 90, 90 if causal else 70
    q, do = (torch.from_numpy(rng.normal(size=(B, T, Hq, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(
        np.float32)) for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = FP.flash_prefill_plain(q, k, v, return_lse=True, **kw)
    want = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
    got = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= BWD_RTOL * scale, f"d{name}"


def test_flash_prefill_lse_and_empty_rows():
    """The plain log-sum-exp is -inf on a row with no valid key (here: T
    past S + window) and finite elsewhere; the tiled backward gives those
    rows zero gradients and matches autograd on the rest."""
    g = torch.Generator().manual_seed(0)
    q, do = torch.randn(1, 40, 4, 64, generator=g), torch.randn(
        1, 40, 4, 64, generator=g)
    k, v = torch.randn(1, 12, 2, 64, generator=g), torch.randn(
        1, 12, 2, 64, generator=g)
    o, lse = FP.flash_prefill_plain(q, k, v, causal=True, window=8,
                                    return_lse=True)
    empty = torch.arange(40) >= 12 + 8 - 1
    assert bool(torch.isinf(lse[..., empty]).all())
    assert bool(torch.isfinite(lse[..., ~empty]).all())
    dq, dk, dv = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse,
                                                  causal=True, window=8)
    assert bool((dq[:, empty] == 0).all())
    want = FP.flash_prefill_bwd_plain(q, k, v, do, causal=True, window=8)
    for got, w in zip((dq, dk, dv), want):
        assert float((got - w).abs().max()) <= BWD_RTOL * float(
            w.abs().max())


def test_flash_prefill_fn_carries_the_plain_gradient_on_cpu():
    """``FlashPrefillFn`` (what a CUDA call that requires grad goes
    through) on CPU tensors: the plain forward and its autograd backward,
    so the wiring (saved tensors, argument order, gradients of the flags)
    gives autograd's own gradients bit for bit."""
    g = torch.Generator().manual_seed(1)
    leaves = [torch.randn(s, generator=g).requires_grad_()
              for s in ((2, 33, 8, 80), (2, 33, 2, 80), (2, 33, 2, 80))]
    do = torch.randn(2, 33, 8, 80, generator=g)
    out = FP.FlashPrefillFn.apply(*leaves, False, 0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want = FP.flash_prefill_bwd_plain(*leaves, do, causal=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_prefill_plain_at_head_dim_80_matches_pallas(causal):
    """hubert-xlarge's head_dim (1280 / 16 = 80), bidirectional as its
    encoder runs, and causal; f32."""
    rng = np.random.default_rng(11)
    T, Hq, D = 100, 4, 80
    qj, qt = _pair(rng.normal(size=(2, T, Hq, D)).astype(np.float32),
                   "float32")
    kj, kt = _pair(rng.normal(size=(2, T, Hq, D)).astype(np.float32),
                   "float32")
    vj, vt = _pair(rng.normal(size=(2, T, Hq, D)).astype(np.float32),
                   "float32")
    with _ieee_f32_matmuls():
        want = jax_flash(qj, kj, vj, causal=causal, block_q=32, block_k=64,
                         interpret=True)
        got = flash_prefill_op(qt, kt, vt, causal=causal)
    _close(got, _flash_oracle(qt, kt, vt, "float32", causal=causal),
           "float32")
    _close(got, want, "float32")
