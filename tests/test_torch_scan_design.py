"""The designs of the port's two scan kernels, emulated in PyTorch on the
CPU and held against the JAX package's step-by-step oracles.

``csrc/rwkv6_scan.cu`` computes WKV6 chunk-parallel in three passes (each
chunk's decay and state delta; the states entering each chunk, in chunk
order; each chunk's output from its entering state and its causal score
tile, built over 16-step sub-blocks with every exponent <= 0), with its
products in the 3xTF32 split on the tensor cores.  ``csrc/rglru_scan.cu``
splits time into chunks: each chunk's aggregate, the carry composed in
chunk order, and a rescan.  The CUDA code runs only on the card; these
emulations repeat its decompositions (the same chunks, sub-blocks,
factorings, carries and 3xTF32 splits, the tensor cores' TF32 rounding
done on the f32 bit pattern), so that the decompositions themselves are
checked here, against ``repro.kernels.ref.rwkv6_ref`` and
``rglru_scan_ref`` (inputs made with numpy from a seed), at the limits
``chip_smoke.py`` holds the kernels to on the card."""
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RS  # noqa: E402

CHUNK = RS.KERNEL_CHUNK     # 64 steps, four sub-blocks of 16
SUB = 16
# chip_smoke.py's TOL["rwkv6"] and TOL["rglru"]:
# |got - want| <= atol + atol_rms * rms(want) + rtol * |want|
TOL_RWKV6 = dict(atol=0.0, atol_rms=1e-4, rtol=1e-4)
TOL_RGLRU = dict(atol=1e-5, atol_rms=0.0, rtol=1e-5)


def worst_share(got, want, atol, atol_rms, rtol):
    """The largest share of its limit that any element uses (<= 1 holds)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    limit = atol + atol_rms * np.sqrt(np.mean(want ** 2)) + rtol * np.abs(want)
    assert np.isfinite(got).all()
    return float(np.max(np.abs(got - want) / limit))


# --------------------------------------------------------------- rwkv6 --
def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does: on the f32 bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernel's mma3: big = tf32(x), small = tf32(x - big);
    small*big + big*small + big*big, each product exact, sums in f32."""
    ab, bb = tf32(a), tf32(b)
    a_s, b_s = tf32(a - ab), tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def mm_tf32(a, b):
    """a @ b in one TF32 pass: what the split avoids."""
    return tf32(a) @ tf32(b)


def rwkv6_emulated(r, k, v, w, u, s0=None, mm=mm_3xtf32):
    """The three passes of csrc/rwkv6_scan.cu on (B,T,H,D) f32 tensors;
    returns (o (B,T,H,D), final state (B,H,D,D))."""
    B, T, H, D = r.shape
    n = -(-T // CHUNK)
    pad = n * CHUNK - T

    def chunks(x):                                   # (B, H, n, c, D)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, CHUNK, H, D).permute(0, 3, 1, 2, 4)

    lw = torch.log2(torch.clamp(w, min=1e-12))
    r, k, v, lw = chunks(r), chunks(k), chunks(v), chunks(lw)  # pad: w = 1
    C = torch.cumsum(lw, dim=3)                      # inclusive sums
    Cx = torch.cat([torch.zeros_like(C[..., :1, :]), C], dim=3)
    E = Cx[..., :CHUNK, :]                           # exclusive sums

    # (a) each chunk's decay and state delta k_end^T v
    c_end = C[..., -1:, :]
    dec = torch.exp2(c_end[..., 0, :])               # (B, H, n, D)
    k_end = k * torch.exp2(c_end - C)                # exponents <= 0
    dS = mm(k_end.transpose(-1, -2), v)              # (B, H, n, D, D)

    # (b) the states entering each chunk, in chunk order
    S = (torch.zeros((B, H, D, D)) if s0 is None else s0.clone())
    s_in = []
    for c in range(n):
        s_in.append(S)
        S = dec[:, :, c, :, None] * S + dS[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    # (c) the score tile: inside a sub-block one exp per (t, s, d) ...
    t_idx = torch.arange(CHUNK)
    same = (t_idx[:, None] // SUB) == (t_idx[None, :] // SUB)
    below = same & (t_idx[None, :] < t_idx[:, None])
    expo = E[..., :, None, :] - C[..., None, :, :]   # (.., t, s, D)
    expo = torch.where(below[..., None], expo, float("-inf"))
    A = torch.einsum("...td,...sd,...tsd->...ts", r, k, torch.exp2(expo))
    # ... and the bonus on its diagonal
    A = A + torch.diag_embed((r * u[None, :, None, None, :] * k).sum(-1))
    # ... across sub-blocks j < i: (r 2^(E - Y_j)) (k 2^(Y_j - C))^T on
    # the tensor cores, Y_j = C at the end of sub-block j
    for i in range(1, CHUNK // SUB):
        rows = slice(i * SUB, (i + 1) * SUB)
        for j in range(i):
            cols = slice(j * SUB, (j + 1) * SUB)
            Y = Cx[..., (j + 1) * SUB:(j + 1) * SUB + 1, :]
            A[..., rows, cols] = mm(
                r[..., rows, :] * torch.exp2(E[..., rows, :] - Y),
                (k[..., cols, :] * torch.exp2(Y - C[..., cols, :]))
                .transpose(-1, -2))
    # o = r_dec S_in + A v, one accumulator
    o = mm(r * torch.exp2(E), s_in) + mm(A, v)       # (B, H, n, c, D)
    o = o.permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, D)[:, :T]
    return o, S


def _rwkv6_inputs(B, T, H, D, s0, decay, seed):
    """chip_smoke.py's rwkv6 inputs: "fast" decays put a 128-step chunk's
    log-decay sum near -500, where the reference's chunked form
    overflows."""
    rng = np.random.default_rng(seed)
    shape = (B, T, H, D)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) * 0.5
               for _ in range(3))
    lo, hi = (0.6, 0.999) if decay == "slow" else (1e-3, 0.05)
    w = rng.uniform(lo, hi, shape).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    state = (rng.standard_normal((B, H, D, D)).astype(np.float32) if s0
             else None)
    return r, k, v, w, u, state


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


RWKV6_CASES = [  # B, T, H, D, carried-in state, decay
    (1, 300, 2, 64, False, "slow"),      # ragged: 4 chunks and 44 steps
    (1, 40, 2, 64, False, "slow"),       # below one chunk
    (1, 1, 2, 64, False, "slow"),        # T = 1
    (1, 65, 2, 64, False, "slow"),       # one step past a chunk
    (2, 130, 2, 64, True, "slow"),       # s0 carried in, B = 2
    (1, 150, 2, 128, False, "slow"),     # D = 128
    (1, 190, 2, 64, True, "fast"),       # the chunked reference overflows
    (1, 190, 2, 128, True, "fast"),
]


@pytest.mark.parametrize("B,T,H,D,s0,decay", RWKV6_CASES)
def test_rwkv6_design_matches_step_reference(B, T, H, D, s0, decay):
    inputs = _rwkv6_inputs(B, T, H, D, s0, decay, seed=T + D)
    o, state = rwkv6_emulated(*_torch(*inputs))
    want_o, want_s = ref.rwkv6_ref(*_jax(*inputs))
    assert o.shape == (B, T, H, D) and state.shape == (B, H, D, D)
    assert worst_share(o, want_o, **TOL_RWKV6) <= 1.0
    assert worst_share(state, want_s, **TOL_RWKV6) <= 1.0
    if decay == "fast":        # the case the sub-block factoring exists for
        ch_o, _ = JL.rwkv6_chunked_jnp(*_jax(*inputs))
        assert not np.isfinite(np.asarray(ch_o)).all()


def test_rwkv6_single_pass_tf32_misses_the_limit():
    """One TF32 pass per product keeps ~11 bits of each operand: at a
    rwkv6-3b-like head (D 64, several chunks) its output leaves the 1e-4
    limit that the 3xTF32 split holds."""
    inputs = _rwkv6_inputs(1, 256, 2, 64, False, "slow", seed=7)
    want_o, _ = ref.rwkv6_ref(*_jax(*inputs))
    split, _ = rwkv6_emulated(*_torch(*inputs))
    single, _ = rwkv6_emulated(*_torch(*inputs), mm=mm_tf32)
    assert worst_share(split, want_o, **TOL_RWKV6) <= 1.0
    assert worst_share(single, want_o, **TOL_RWKV6) > 1.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -1.0 - 2.0 ** -11,
                      1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10,
            1.0 + 2.0 ** -10, 3.0]    # half away from zero, as cvt.rna
    assert tf32(x).tolist() == want
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
    rest = y - big - tf32(y - big)         # what the split drops
    assert float((rest.abs() / y.abs()).max()) <= 2.0 ** -21


# --------------------------------------------------------------- rglru --
def rglru_emulated(log_a, b, h0=None, chunk=None):
    """The two passes of csrc/rglru_scan.cu on (B,T,d) f32 tensors, at the
    kernel's time chunk for this T unless given; returns every h."""
    B, T, d = log_a.shape
    chunk = RG.time_chunk(T) if chunk is None else chunk
    n = -(-T // chunk)
    pad = n * chunk - T
    la = torch.nn.functional.pad(log_a, (0, 0, 0, pad)).reshape(B, n, chunk, d)
    bb = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(B, n, chunk, d)
    # pass 1: every chunk's decay product and its h from zero (the last
    # chunk's aggregate is never used)
    h = torch.zeros((B, n, d))
    P = torch.ones((B, n, d))
    for i in range(chunk):
        a = torch.exp(la[:, :, i])
        h = a * h + bb[:, :, i]
        P = a * P
    # pass 2: the carry in chunk order, then the rescan
    carry = torch.zeros((B, d)) if h0 is None else h0.clone()
    h_in = []
    for c in range(n):
        h_in.append(carry)
        carry = P[:, c] * carry + h[:, c]
    h = torch.stack(h_in, dim=1)
    out = torch.empty((B, n, chunk, d))
    for i in range(chunk):
        h = torch.exp(la[:, :, i]) * h + bb[:, :, i]
        out[:, :, i] = h
    return out.reshape(B, n * chunk, d)[:, :T]


def _rglru_inputs(B, T, d, h0, decay, seed):
    """chip_smoke.py's rglru inputs, b = sqrt(1 - a^2) x: "model" takes
    the model's range of log_a (a chunk's decay product underflows to 0,
    so the carry adds nothing), "slow" tests/test_kernels.py's
    -|N(0,1)| / 10 (a 32-step chunk keeps ~7% of its carried h)."""
    rng = np.random.default_rng(seed)
    if decay == "model":
        gate = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, d))))
        log_a = -8.0 * np.log1p(np.e) * gate
    else:
        log_a = -np.abs(rng.standard_normal((B, T, d))) * 0.1
    b = (np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_a), 1e-12))
         * rng.standard_normal((B, T, d)))
    state = rng.standard_normal((B, d)) if h0 else None
    return [None if x is None else x.astype(np.float32)
            for x in (log_a, b, state)]


RGLRU_CASES = [  # B, T, d, carried-in h0, decay
    (1, 150, 24, False, "model"),    # ragged: 4 chunks and 22 steps
    (1, 150, 24, False, "slow"),
    (1, 20, 24, False, "slow"),      # below one chunk
    (1, 1, 24, False, "model"),      # T = 1
    (1, 33, 24, False, "slow"),      # one step past a chunk
    (2, 200, 10, True, "model"),     # h0 carried in; d off the 4-channel vector
    (2, 200, 10, True, "slow"),
    (1, 2053, 8, True, "slow"),      # past 64 chunks of 32: chunks of 33 steps
]


@pytest.mark.parametrize("B,T,d,h0,decay", RGLRU_CASES)
def test_rglru_design_matches_step_reference(B, T, d, h0, decay):
    inputs = _rglru_inputs(B, T, d, h0, decay, seed=T + d)
    got = rglru_emulated(*_torch(*inputs))
    want = ref.rglru_scan_ref(*_jax(*inputs))
    assert got.shape == (B, T, d)
    assert worst_share(got, want, **TOL_RGLRU) <= 1.0


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_rglru_design_at_other_chunks(chunk):
    """The sizes profile_port.py's sweep times: the split is exact for any
    chunk, up to the rounding of the composed decays."""
    inputs = _rglru_inputs(1, 300, 16, True, "slow", seed=chunk)
    got = rglru_emulated(*_torch(*inputs), chunk=chunk)
    want = ref.rglru_scan_ref(*_jax(*inputs))
    assert worst_share(got, want, **TOL_RGLRU) <= 1.0


def test_rglru_time_chunk_bounds_the_carry():
    assert RG.time_chunk(1) == RG.time_chunk(1024) == RG.CHUNK == 32
    assert RG.time_chunk(2048) == 32
    for T in (2049, 4096, 32768, 100_003):
        chunk = RG.time_chunk(T)
        assert chunk > 32 and -(-T // chunk) <= RG.MAX_CHUNKS


if __name__ == "__main__":
    # The worst element's share of its limit against rwkv6_ref, o and state,
    # in the 3xTF32 split and in one TF32 pass, for each case above:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_scan_design.py
    for case in RWKV6_CASES:
        inputs = _rwkv6_inputs(*case, seed=case[1] + case[3])
        want = ref.rwkv6_ref(*_jax(*inputs))
        shares = []
        for mm in (mm_3xtf32, mm_tf32):
            got = rwkv6_emulated(*_torch(*inputs), mm=mm)
            shares += [worst_share(g, x, **TOL_RWKV6)
                       for g, x in zip(got, want)]
        print("rwkv6 B={} T={} H={} D={} s0={} decay={}".format(*case),
              "3xTF32 o {:.3f} state {:.3f}; one TF32 pass o {:.2f} state "
              "{:.2f}".format(*shares))
