"""The designs of the port's f32 attention kernels and of the bf16
backward, emulated in PyTorch on the CPU and held against the plain
versions at the card's limits.

``csrc/flash_prefill.cu``'s f32 path runs one warp per 16 flattened rows
(the G query heads of a kv head stacked, row t*G + g) over K/V tiles of 64
keys (32 at D 256) with an online softmax, and both products (S = Q K^T,
O += P V) on the tensor cores in the 3xTF32 split.  ``csrc/flash_prefill_
bwd.cu`` recomputes P from the forward's log-sum-exp on its own tiles,
runs its five products in the same split, and where its dK/dV launch
would fill under two waves of the card it splits each key tile's q tiles
into ranges whose partial sums a third launch adds in range order
(``flash_prefill_bwd_tiled_plain``, ``bwd_split``).  The CUDA code runs
only on the card; these emulations repeat its tiles, ranges and splits
(the tensor cores' TF32 rounding done on the f32 bit pattern, as
``cvt.rna`` does), so that the designs themselves are checked here, on
inputs made with numpy from a seed, at the limits ``chip_smoke.py`` holds
the kernels to: f32 2e-5 (absolute and relative) on the output and the
log-sum-exp, and 1e-4 of each gradient's rms and of |plain| on dQ, dK, dV.
One TF32 pass per product misses the f32 limit.  (The tensor cores' own
sums truncate rather than round; that is not emulated here.  The kernels
keep those chains short: each tile's P V, dS K, P^T dO and dS^T Q summed in
a fresh accumulator and added in f32, and the small cross terms of S and
dP summed apart from big*big.)

The bf16 backward (``csrc/flash_prefill_bwd_bf16.cu``) walks the same
ranges and splits on its own tiles (``bwd_tiles(D, torch.bfloat16)``:
64-row warpgroup tiles for ``wgmma``), with f32 sums: P and dS rounded to
bf16 as the operands of dV, dK and dQ, Q, K, V and dO bf16 already.  Its emulation
is ``flash_prefill_bwd_tiled_plain`` with ``mm_bf16``, fed the plain
forward's bf16 output and log-sum-exp, its gradients rounded to bf16,
against autograd of the plain forward in bf16, at ``chip_smoke.py``'s
bf16 gradient limit.  The plain version rounds elsewhere (dP and its
outputs), and where dP and delta nearly cancel in dS either side's
rounding moves an element by a share of its gradient's rms: hence that
limit's 0.2 of the rms, beside a 1e-2 limit on each gradient's relative
L2 difference."""
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
# The first torch.exp of a CPU process can be less accurate on part of its
# tensor (torch 2.13): one call before any f32 comparison (ROADMAP Queue 3).
torch.exp(torch.zeros(64))

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from test_torch_scan_design import (  # noqa: E402
    mm_3xtf32, mm_tf32, worst_share)

# chip_smoke.py's TOL["float32"] and TOL["grad"]:
# |got - want| <= atol + atol_rms * rms(want) + rtol * |want|
TOL_F32 = dict(atol=2e-5, atol_rms=0.0, rtol=2e-5)
TOL_GRAD = dict(atol=0.0, atol_rms=1e-4, rtol=1e-4)
# chip_smoke.py's TOL["grad_bf16"] and GRAD_BF16_REL_L2
TOL_GRAD_BF16 = dict(atol=0.0, atol_rms=0.2, rtol=2.0 ** -6)
GRAD_BF16_REL_L2 = 1e-2


def mm_bf16(a, b):
    """The bf16 backward's products: both operands rounded to bf16 (P and
    dS; the others are bf16 already), the sum in f32."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def flash_emulated(q, k, v, *, causal, window=0, q_offset=0, mm=mm_3xtf32):
    """The f32 forward kernel's algorithm on (B,T,Hq,D) / (B,S,Hkv,D) f32
    tensors: q tiles of ``fwd_tiles(D)[0] // G`` positions, the key tiles
    the masks leave open, an online softmax over them, products through
    ``mm``; returns (out (B,T,Hq,D), lse (B,Hq,T))."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, scale = Hq // Hkv, D ** -0.5
    rows, bk = FP.fwd_tiles(D)
    block_q = rows // G
    qg = q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4)   # B,Hkv,T,G,D
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)    # B,Hkv,S,D
    out = torch.zeros((B, Hkv, T, G, D))
    lse = torch.zeros((B, Hkv, T, G))
    for t0 in range(0, T, block_q):
        nt = min(block_q, T - t0)
        qt = qg[:, :, t0:t0 + nt].reshape(B, Hkv, nt * G, D)
        pos = q_offset + t0 + torch.arange(nt * G) // G
        p_lo, p_hi = q_offset + t0, q_offset + t0 + nt - 1
        k_end = min(S, p_hi + 1) if causal else S
        k_begin = (max(0, p_lo - window + 1) if window else 0) // bk * bk
        m = torch.full((B, Hkv, nt * G), float("-inf"))
        l = torch.zeros((B, Hkv, nt * G))
        o = torch.zeros((B, Hkv, nt * G, D))
        for k0 in range(k_begin, k_end, bk):
            k1 = min(k0 + bk, S)
            s = mm(qt, kf[:, :, k0:k1].transpose(-1, -2))
            kp = torch.arange(k0, k1)
            ok = torch.ones((nt * G, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= kp <= pos[:, None]
            if window:
                ok &= kp > pos[:, None] - window
            s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            msc = torch.where(m_new == float("-inf"), 0.0, m_new * scale)
            alpha = torch.exp(m * scale - msc)
            p = torch.exp(s * scale - msc[..., None])
            l = alpha * l + p.sum(-1)
            o = alpha[..., None] * o + mm(p, vf[:, :, k0:k1])
            m = m_new
        o = torch.where(l[..., None] > 0, o / l.clamp_min(1e-30)[..., None],
                        0.0)
        out[:, :, t0:t0 + nt] = o.reshape(B, Hkv, nt, G, D)
        lse[:, :, t0:t0 + nt] = torch.where(
            l > 0, m * scale + torch.log(l), float("-inf")).reshape(
                B, Hkv, nt, G)
    return (out.permute(0, 2, 1, 3, 4).reshape(B, T, Hq, D),
            lse.permute(0, 1, 3, 2).reshape(B, Hq, T))


def _inputs(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, Hq, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(
        np.float32)) for _ in range(2))
    return q, k, v, do


def _lse_share(got, want):
    """The log-sum-exp's worst share of the f32 limit; -inf (a row with no
    valid key) must be -inf on both sides."""
    empty = torch.isinf(want)
    assert torch.equal(empty, torch.isinf(got))
    return worst_share(got.masked_fill(empty, 0.0),
                       want.masked_fill(empty, 0.0), **TOL_F32)


CASES = [  # B, T, S, Hq, Hkv, D, causal, window
    (2, 150, 150, 2, 2, 80, False, 0),     # hubert-xlarge's heads: G 1, bidir.
    (1, 140, 140, 8, 2, 128, True, 0),     # llama3-8b's G 4, causal
    (1, 90, 90, 10, 1, 256, True, 40),     # recurrentgemma-2b's G 10, window
]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,window", CASES)
def test_forward_design_holds_the_f32_limit(B, T, S, Hq, Hkv, D, causal,
                                            window):
    q, k, v, _ = _inputs(B, T, S, Hq, Hkv, D, seed=D)
    kw = dict(causal=causal, window=window)
    got, lse = flash_emulated(q, k, v, **kw)
    want, want_lse = FP.flash_prefill_plain(q, k, v, return_lse=True, **kw)
    assert worst_share(got, want, **TOL_F32) <= 1.0
    assert _lse_share(lse, want_lse) <= 1.0


def test_forward_design_offsets_and_empty_rows():
    """A chunked prefill past its window (q_offset) and rows with no valid
    key: zeros out, -inf log-sum-exp, as the plain version gives."""
    q, k, v, _ = _inputs(1, 60, 20, 4, 2, 64, seed=5)
    got, lse = flash_emulated(q, k, v, causal=True, window=8)
    want, want_lse = FP.flash_prefill_plain(q, k, v, causal=True, window=8,
                                            return_lse=True)
    assert bool(torch.isinf(want_lse).any())
    assert worst_share(got, want, **TOL_F32) <= 1.0
    assert _lse_share(lse, want_lse) <= 1.0
    q, k, v, _ = _inputs(1, 40, 190, 4, 2, 64, seed=6)
    got, lse = flash_emulated(q, k, v, causal=True, window=100, q_offset=150)
    want, want_lse = FP.flash_prefill_plain(q, k, v, causal=True, window=100,
                                            q_offset=150, return_lse=True)
    assert worst_share(got, want, **TOL_F32) <= 1.0
    assert _lse_share(lse, want_lse) <= 1.0


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,window", CASES)
def test_forward_single_pass_tf32_misses_the_limit(B, T, S, Hq, Hkv, D,
                                                   causal, window):
    """One TF32 pass per product keeps ~11 bits of each operand: the
    output leaves the f32 limit that the 3xTF32 split holds."""
    q, k, v, _ = _inputs(B, T, S, Hq, Hkv, D, seed=D)
    kw = dict(causal=causal, window=window)
    want = FP.flash_prefill_plain(q, k, v, **kw)
    single, _ = flash_emulated(q, k, v, mm=mm_tf32, **kw)
    assert worst_share(single, want, **TOL_F32) > 1.0


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,window", CASES + [
    (1, 70, 30, 4, 2, 64, True, 20),       # rows with no valid key
])
def test_backward_design_holds_the_grad_limit(B, T, S, Hq, Hkv, D, causal,
                                              window):
    """The backward's tiles and 3xTF32 products, fed the emulated
    forward's output and log-sum-exp as the kernel is fed the forward
    kernel's, against autograd of the plain forward; these shapes fill
    under two waves, so the dK/dV ranges are split (2-4) and summed."""
    q, k, v, do = _inputs(B, T, S, Hq, Hkv, D, seed=D + 1)
    kw = dict(causal=causal, window=window)
    assert FP.bwd_split(B, Hkv, S, D, 132) > 1
    o, lse = flash_emulated(q, k, v, **kw)
    got = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse, mm=mm_3xtf32,
                                           **kw)
    want = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert worst_share(g, w, **TOL_GRAD) <= 1.0


def test_backward_split_sums_like_one_range():
    """The same gradients with the dK/dV launch split in 4 ranges and in
    one: the split changes only the order of the sums."""
    q, k, v, do = _inputs(1, 100, 100, 8, 2, 64, seed=9)
    o, lse = FP.flash_prefill_plain(q, k, v, return_lse=True)
    split = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse, n_sm=132)
    whole = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse, n_sm=1)
    assert FP.bwd_split(1, 2, 100, 64, 132) == 4
    assert FP.bwd_split(1, 2, 100, 64, 1) == 1
    for a, b in zip(split, whole):
        assert worst_share(a, b, **TOL_GRAD) <= 0.1


BF16_CASES = [  # B, T, S, Hq, Hkv, D, causal, window
    (1, 256, 256, 32, 8, 128, True, 0),    # llama3-8b's heads: G 4, causal
    (1, 512, 512, 10, 1, 256, True, 128),  # recurrentgemma-2b's G 10, window
    (2, 200, 200, 8, 2, 64, True, 0),      # D 64
    (1, 300, 300, 16, 4, 64, False, 0),    # bidirectional, G 4
    (1, 70, 30, 4, 2, 64, True, 20),       # rows with no valid key
    # T*G = 2030 rows, off the 64-row steps and 128-row tiles, at G 10
    # under a window
    (1, 203, 203, 10, 1, 256, True, 50),
    (2, 800, 800, 8, 4, 256, True, 0),     # D 256, dK/dV over 3 ranges
]


def _bf16_inputs(B, T, S, Hq, Hkv, D, seed):
    return tuple(x.to(torch.bfloat16)
                 for x in _inputs(B, T, S, Hq, Hkv, D, seed))


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,window", BF16_CASES)
def test_bf16_backward_design_holds_the_bf16_grad_limit(B, T, S, Hq, Hkv, D,
                                                        causal, window):
    """The bf16 backward's tiles, dK/dV ranges and products (``mm_bf16``),
    from the plain forward's bf16 output and f32 log-sum-exp, its
    gradients rounded to bf16 as the kernel writes them, against autograd
    of the plain forward on the same bf16 inputs."""
    q, k, v, do = _bf16_inputs(B, T, S, Hq, Hkv, D, seed=D + 2)
    kw = dict(causal=causal, window=window)
    o, lse = FP.flash_prefill_plain(q, k, v, return_lse=True, **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse, mm=mm_bf16,
                                           **kw)
    want = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert w.dtype == torch.bfloat16 and g.shape == w.shape
        g = g.to(torch.bfloat16).float()
        assert worst_share(g, w.float(), **TOL_GRAD_BF16) <= 1.0
        assert rel_l2(g, w.float()) <= GRAD_BF16_REL_L2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("q_offset", [0, 7])
def test_no_backward_reason_refuses_exactly_bf16_d80_and_offsets(dtype, D,
                                                                 q_offset):
    """The backward kernel takes f32 at D 64 / 80 / 128 / 256 and bf16 at
    D 64 / 128 / 256, q_offset 0: a CUDA call that requires grad raises
    for bf16 at D 80 (no bf16 forward there either) and for a q_offset,
    and for nothing else of these."""
    refused = bool(FP.no_backward_reason(dtype, D, q_offset))
    assert refused == ((dtype == torch.bfloat16 and D == 80) or q_offset > 0)


@pytest.mark.parametrize("B,Hkv,S,D,n_split", [
    (1, 1, 4096, 256, 4),      # recurrentgemma-2b training: 64 key tiles
    (1, 8, 1024, 256, 3),      # 128 blocks
    (4, 8, 1024, 128, 2),      # llama3-8b training: 256 blocks
    (8, 16, 1024, 80, 1),      # hubert-xlarge training: 1024 blocks
    (2, 10, 1024, 256, 1),     # 320 blocks: two waves and more
    (1, 1, 0, 64, 1),          # no keys
])
def test_bwd_split_rule(B, Hkv, S, D, n_split):
    assert FP.bwd_split(B, Hkv, S, D, 132) == n_split


@pytest.mark.parametrize("B,Hkv,S,D,n_split", [
    (1, 1, 4096, 256, 4),      # recurrentgemma-2b training: 64 key tiles
    (2, 4, 800, 256, 3),       # 104 blocks
    (1, 8, 1024, 256, 3),      # 128 blocks: just under one wave
    (4, 8, 1024, 128, 1),      # llama3-8b training: 256 blocks
    (1, 17, 1024, 128, 1),     # 136 blocks: one wave and a bit
    (8, 8, 2048, 64, 1),       # 1024 blocks
    (1, 2, 200, 64, 4),        # 4 blocks
])
def test_bwd_split_rule_bf16(B, Hkv, S, D, n_split):
    """The bf16 kernel's dK/dV tiles (128 keys, 64 at D 256) split only
    under one wave of blocks: at llama3-8b's training shape (256 blocks
    on 132 SMs) the split and its third launch cost more than they
    save."""
    assert FP.bwd_split(B, Hkv, S, D, 132, torch.bfloat16) == n_split


# The bf16 backward's shared memory a block may ask for (the H100's 227 KB)
SMEM_LIMIT = 232_448


def bf16_bwd_smem_bytes(D):
    """Dynamic shared memory of the bf16 backward's two launches at head
    dim D, from its tiles, as ``dq_smem_bytes`` and ``dkdv_smem_bytes`` in
    ``csrc/flash_prefill_bwd_bf16.cu`` count it: bf16 tiles (Q and dO, and
    a 2-stage K/V ring; K and V, and a Q/dO ring of 4 stages, 2 at D 256),
    f32 lse and delta of the rows, at D 256 the f32 P^T that one warpgroup
    passes the other (64 keys by the step's rows), 1 KB to align the
    base."""
    dq_rows, dq_keys, kv_keys, kv_rows = FP.bwd_tiles(D, torch.bfloat16)
    kv_stages = 2 if D > 128 else 4
    dq = (2 * dq_rows + 2 * 2 * dq_keys) * D * 2 + 2 * dq_rows * 4 + 1024
    kv = ((2 * kv_keys + 2 * kv_stages * kv_rows) * D * 2
          + (2 * kv_stages * kv_rows + (64 * kv_rows if D > 128 else 0)) * 4
          + 1024)
    return dq, kv


def test_tiles_fit_the_kernels():
    """The tiles the emulations take are the kernels': 8 warps of 16 rows
    and 64-key tiles up to D 128; 4 warps and 32-key tiles at D 256.  The
    bf16 backward's are 64-row warpgroup tiles, two warpgroups a block,
    and each of its launches fits the shared memory of a block."""
    assert [FP.fwd_tiles(D) for D in (64, 80, 128, 256)] == [
        (128, 64), (128, 64), (128, 64), (64, 32)]
    assert [FP.bwd_tiles(D) for D in (64, 80, 128, 256)] == [
        (128, 32, 128, 32), (128, 32, 128, 32), (128, 32, 128, 16),
        (64, 16, 64, 16)]
    assert [FP.bwd_tiles(D, torch.bfloat16) for D in (64, 128, 256)] == [
        (128, 64, 128, 64), (128, 64, 128, 64), (128, 32, 64, 64)]
    smem = [bf16_bwd_smem_bytes(D) for D in (64, 128, 256)]
    assert smem == [(67_584, 101_376), (133_120, 199_680),
                    (198_656, 215_040)]
    assert max(max(x) for x in smem) <= SMEM_LIMIT


if __name__ == "__main__":
    # The worst element's share of its limit against the plain versions, in
    # the 3xTF32 split and in one TF32 pass, for each case above:
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu python \
    #       tests/test_torch_attention_design.py
    for case in CASES:
        B, T, S, Hq, Hkv, D, causal, window = case
        q, k, v, do = _inputs(B, T, S, Hq, Hkv, D, seed=D)
        kw = dict(causal=causal, window=window)
        want, want_lse = FP.flash_prefill_plain(q, k, v, return_lse=True,
                                                **kw)
        want_g = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
        shares = []
        for mm in (mm_3xtf32, mm_tf32):
            o, lse = flash_emulated(q, k, v, mm=mm, **kw)
            g = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse, mm=mm,
                                                 **kw)
            shares += [worst_share(o, want, **TOL_F32),
                       max(worst_share(a, b, **TOL_GRAD)
                           for a, b in zip(g, want_g))]
        print("B={} T={} S={} Hq={} Hkv={} D={} causal={} window={}".format(
            *case), "3xTF32 out {:.3f} grads {:.3f}; one TF32 pass out "
            "{:.2f} grads {:.2f}".format(*shares))
    # the bf16 backward's: worst share of the bf16 gradient limit and
    # largest relative L2 difference over dQ, dK, dV
    for case in BF16_CASES:
        B, T, S, Hq, Hkv, D, causal, window = case
        q, k, v, do = _bf16_inputs(B, T, S, Hq, Hkv, D, seed=D + 2)
        kw = dict(causal=causal, window=window)
        o, lse = FP.flash_prefill_plain(q, k, v, return_lse=True, **kw)
        got = FP.flash_prefill_bwd_tiled_plain(q, k, v, o, do, lse,
                                               mm=mm_bf16, **kw)
        want = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
        pairs = [(g.to(torch.bfloat16).float(), w.float())
                 for g, w in zip(got, want)]
        print("bf16 B={} T={} S={} Hq={} Hkv={} D={} causal={} "
              "window={}".format(*case), "grads {:.3f} of the limit, "
              "relative L2 {:.4f}".format(
                  max(worst_share(g, w, **TOL_GRAD_BF16) for g, w in pairs),
                  max(rel_l2(g, w) for g, w in pairs)))
