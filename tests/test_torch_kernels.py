"""The port's attention kernels on the CPU: each wrapper's plain PyTorch
version against the JAX package's Pallas kernel run in interpret mode, on
the inputs of ``tests/test_kernels.py`` (made with numpy from a seed), plus
the wrappers' dispatch and input checks.  The CUDA kernels themselves run
only on the card (``chip_smoke.py``)."""
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    atol = tol["atol"] + tol["atol_rms"] * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64),       # MHA square
    (2, 128, 128, 8, 2, 64),       # GQA 4:1
    (1, 96, 96, 4, 1, 128),        # MQA, non-multiple T
    (2, 256, 256, 10, 2, 128),     # G=5 odd grouping
    (1, 80, 80, 10, 1, 256),       # recurrentgemma-2b: G=10, D=256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_plain_matches_pallas(B, T, S, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng.normal(size=(B, T, Hq, D)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, D)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, D)).astype(np.float32), dtype)
    want = jax_flash(qj, kj, vj, causal=True, block_q=64, block_k=64,
                     interpret=True)
    got = FP.flash_prefill(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
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
