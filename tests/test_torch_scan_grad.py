"""The scans' gradients on the CPU: autograd of the port's plain versions
against ``jax.grad`` of the JAX package's jnp functions, and the backward
kernels' designs, emulated in PyTorch, against float64 step-by-step
oracles.

The JAX package trains by differentiating ``rwkv6_chunked_jnp`` and
``rglru_scan_jnp`` (``repro.models.layers``); the port's forwards are
kernels, so their gradients are kernels too (``csrc/rwkv6_scan_bwd.cu``,
the backward entry of ``csrc/rglru_scan.cu``).  Those run only on the card
(``chip_smoke.py``); here their decompositions are repeated in PyTorch --
the same chunks, the state gradients carried last chunk first, every
exponent <= 0, the decay's gradient split into terms that each carry the
step's own decay; for rwkv6 the 16-step sub-blocks, the cross-sub-block
pairs factored through a cumulative sum between them, every product in
the 3xTF32 split with the tensor cores' TF32 rounding done on the f32 bit
pattern -- and held to the limit the card holds the kernels to.  (The
tensor cores' own sums truncate; that is not emulated.)  Inputs are made
with numpy from a seed."""
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
# The first torch.exp of a CPU process with 2 intra-op threads can come out
# less accurate on part of its tensor (ROADMAP Queue 3): one call before any
# comparison.
torch.exp(torch.zeros(64))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.layers import rglru_scan_jnp, rwkv6_chunked_jnp  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RS  # noqa: E402
from test_torch_scan_design import mm_3xtf32, mm_tf32  # noqa: E402

CHUNK = RS.KERNEL_CHUNK      # 64, the kernels' chunk
SUB = 16                     # steps of the backward kernel's sub-blocks
NSUB = CHUNK // SUB
# chip_smoke.py's TOL["grad"]: |got - want| <= 1e-4 * rms(want) + 1e-4 *
# |want| per element.  Plain vs JAX: the same chunked form in f32 with sums
# in another order (the decay's gradient cancels terms of order 1 in both,
# which the limit's rms term covers at these decays).  Emulation vs the
# float64 oracle: f32 sums over up to T*D terms.
GRAD_ATOL_RMS, GRAD_RTOL = 1e-4, 1e-4


def assert_grad_close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    atol = GRAD_ATOL_RMS * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=name)


# ------------------------------------------------------------- inputs --
def rwkv6_inputs(seed, B, T, H, decay, carried, with_ds, D=64):
    """r, k, v, w, u, s0 (or None), do, ds_final (or None), f32 numpy.
    ``decay``: "slow" w in (0.9, 0.999); "fast" w in (1e-3, 0.05), where a
    128-step chunk's log-decay sum reaches ~-600 and the chunked form's
    k exp(-cum) overflows; "clamp": slow, with w = 1e-13 (under the 1e-12
    clamp) at one step of each 64 (few enough that the chunked form's
    exponents stay below f32's limit)."""
    rng = np.random.default_rng(seed)
    shape = (B, T, H, D)

    def f(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    r, k, v = f(*shape, sc=0.5), f(*shape, sc=0.5), f(*shape, sc=0.5)
    lo, hi = (1e-3, 0.05) if decay == "fast" else (0.9, 0.999)
    w = rng.uniform(lo, hi, shape).astype(np.float32)
    if decay == "clamp":
        w[:, 5::64, 0, ::7] = 1e-13
    u = f(H, D, sc=0.1)
    s0 = f(B, H, D, D) if carried else None
    ds = f(B, H, D, D) if with_ds else None
    return r, k, v, w, u, s0, f(*shape), ds


def tt(x):
    return None if x is None else torch.from_numpy(x)


def jax_rwkv6_grads(r, k, v, w, u, s0, do, ds):
    """``jax.grad`` of <o, do> + <S, ds> through ``rwkv6_chunked_jnp``."""
    def loss(r, k, v, w, u, s0):
        o, S = rwkv6_chunked_jnp(r, k, v, w, u, s0)
        out = jnp.sum(o * do)
        return out + (jnp.sum(S * ds) if ds is not None else 0.0)

    argnums = (0, 1, 2, 3, 4, 5) if s0 is not None else (0, 1, 2, 3, 4)
    with jax.default_matmul_precision("highest"):
        return jax.grad(loss, argnums=argnums)(r, k, v, w, u, s0)


def wkv6_steps(r, k, v, w, u, s0):
    """The recurrence one step at a time, in the inputs' dtype."""
    B, T, H, D = r.shape
    S = (torch.zeros((B, H, D, D), dtype=r.dtype) if s0 is None else s0)
    outs = []
    for t in range(T):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        o = (rt * u * kt).sum(-1, keepdim=True) * vt
        outs.append(o + torch.einsum("bhd,bhde->bhe", rt, S))
        S = S * w[:, t][..., None] + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, dim=1), S


def oracle_rwkv6_grads(r, k, v, w, u, s0, do, ds):
    """float64 autograd of the step recurrence from w clamped at 1e-12, as
    the kernels and the reference clamp it."""
    ins = [torch.from_numpy(x).double().requires_grad_()
           for x in (r, k, v, w, u) + ((s0,) if s0 is not None else ())]
    o, S = wkv6_steps(*ins[:3], torch.clamp(ins[3], min=1e-12), ins[4],
                      ins[5] if s0 is not None else None)
    outs, cots = [o], [torch.from_numpy(do).double()]
    if ds is not None:
        outs.append(S)
        cots.append(torch.from_numpy(ds).double())
    return torch.autograd.grad(outs, ins, cots)


# ------------------------------------------ rwkv6: the kernel's design --
def sub_blocks(x):
    """(.., 64, D) -> (.., 4, 16, D): a chunk's four sub-blocks."""
    return x.reshape(*x.shape[:-2], NSUB, SUB, x.shape[-1])


def rows(x, a, b):
    return x[..., a * SUB:b * SUB, :]


def exclusive_cumsum(x, dim):
    """sum over the entries before each along ``dim``, with no subtraction
    (an inclusive sum less the entry cancels where the entry dominates)."""
    c = torch.cumsum(x, dim=dim)
    return torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)),
                      c.narrow(dim, 0, c.shape[dim] - 1)], dim=dim)


def prefix_in_sub(g):
    """sum_{s in j's sub-block, s < j} g_s for each step j: (.., 64, D)."""
    return exclusive_cumsum(sub_blocks(g), -2).reshape(g.shape)


def suffix_in_sub(g):
    """sum_{t in j's sub-block, t > j} g_t for each step j: (.., 64, D)."""
    return torch.flip(exclusive_cumsum(torch.flip(sub_blocks(g), [-2]), -2),
                      [-2]).reshape(g.shape)


def intra_pieces(R, K, dA, W):
    """The pairs s < t inside one 16-step sub-block, on the CUDA cores, with
    the decay between them as the running product of W = max(w, 1e-12)
    over s < m < t (each factor <= 1, and no exponent of a long cumulative
    sum, whose f32 rounding grows with the sum): (dr's sum over s, dk's sum
    over t, and the pair sum of d log w_j over s < j < t), each
    (.., 64, D)."""
    t = torch.arange(CHUNK)
    same = (t[:, None] // SUB) == (t[None, :] // SUB)
    intra = same & (t[None, :] < t[:, None])         # [t, s]
    F = W.new_zeros(*W.shape[:-2], CHUNK, CHUNK, W.shape[-1])
    for s in range(CHUNK):
        f = torch.ones_like(W[..., 0, :])
        for t_ in range(s + 1, (s // SUB + 1) * SUB):
            if t_ > s + 1:
                f = f * W[..., t_ - 1, :]
            F[..., t_, s, :] = f
    assert bool((F <= 1).all())
    x = dA[..., None] * F                            # dA[t, s] prod w
    xk = x * K[..., None, :, :]
    dr_i = xk.sum(-2)
    dk_i = torch.einsum("...tsd,...td->...sd", x, R)
    # r_t times dr's sum over s < j: (.., t, j, D)
    pre = R[..., :, None, :] * exclusive_cumsum(xk, -2)
    pairs = torch.einsum("tj,...tjd->...jd", intra.to(x.dtype), pre)
    return dr_i, dk_i, pairs


def cross_pieces(R, K, dA, E, C, Cx, mm):
    """The pairs s < t in different sub-blocks, as products on the tensor
    cores.  dr: for t in sub-block i, through Y' = C at the end of sub-block
    i - 1, 2^(E_t - Y') (dA[t, :16i] (k 2^(Y' - C))[:16i]).  dk: for s in
    sub-block j, through Y_j = C at its end, 2^(Y_j - C_s) (dA[16(j+1):,
    s]^T (r 2^(E - Y_j))[16(j+1):]), the t range walked last sub-block
    first, its partial sums (t in sub-block 3; t in 2 and 3) kept for d log
    w's pairs that span a whole sub-block: case1[c] = the sum over s before
    sub-block c and t after it of dA[t,s] r_t k_s 2^(E_t - C_s).  Returns
    (dr_x, dk_x (.., 64, D), case1 (.., 4, D)); asserts every exponent
    <= 0."""
    dr_x, dk_x = torch.zeros_like(R), torch.zeros_like(K)
    for i in range(1, NSUB):
        Yp = Cx[..., i * SUB:i * SUB + 1, :]
        e_k, e_t = Yp - rows(C, 0, i), rows(E, i, i + 1) - Yp
        assert bool((e_k <= 0).all()) and bool((e_t <= 0).all())
        acc = mm(dA[..., i * SUB:(i + 1) * SUB, :i * SUB],
                 rows(K, 0, i) * torch.exp2(e_k))
        dr_x[..., i * SUB:(i + 1) * SUB, :] = torch.exp2(e_t) * acc
    snaps = {}
    for j in range(NSUB - 1):
        Y = Cx[..., (j + 1) * SUB:(j + 1) * SUB + 1, :]
        e_s, e_t = Y - rows(C, j, j + 1), rows(E, j + 1, NSUB) - Y
        assert bool((e_s <= 0).all()) and bool((e_t <= 0).all())
        f = torch.exp2(e_s)
        r_hat = rows(R, j + 1, NSUB) * torch.exp2(e_t)
        dAT = dA[..., (j + 1) * SUB:, j * SUB:(j + 1) * SUB].transpose(-1, -2)
        for lo in range(j + 2, NSUB):   # t from sub-block lo on
            part = mm(dAT[..., :, (lo - j - 1) * SUB:],
                      r_hat[..., (lo - j - 1) * SUB:, :])
            snaps[j, lo] = (rows(K, j, j + 1) * f * part).sum(-2)
        dk_x[..., j * SUB:(j + 1) * SUB, :] = f * mm(dAT, r_hat)
    zero = torch.zeros_like(R[..., 0, :])
    case1 = torch.stack([zero, snaps[0, 2], snaps[0, 3] + snaps[1, 3], zero],
                        dim=-2)
    return dr_x, dk_x, case1


def rwkv6_bwd_emulated(r, k, v, w, u, s0, do, ds, mm=mm_3xtf32):
    """The passes of csrc/rwkv6_scan_bwd.cu (and, for the states entering
    each chunk, csrc/rwkv6_scan.cu's) in f32 on (B,T,H,D) tensors, every
    product in ``mm`` (the kernel's 3xTF32 split by default): (dr, dk, dv,
    dw, du, ds0 or None).  Per chunk: dA; A^T's diagonal sub-block tiles
    (one exp per (t, s, d)) and cross tiles (products through Y_j), each
    sub-block row of A^T one product with do; the state terms; dr's and
    dk's cross terms (``cross_pieces``) and intra pairs
    (``intra_pieces``); d log w_j from sums over sub-blocks, the pairs that
    span j's sub-block, and prefix and suffix sums inside it.  Asserts
    that every exponent formed is <= 0."""
    B, T, H, D = r.shape
    n = -(-T // CHUNK)
    pad = n * CHUNK - T

    def chunks(x):                                   # (B, H, n, c, D)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, CHUNK, H, D).permute(0, 3, 1, 2, 4)

    def unchunk(x):
        return x.permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, D)[:, :T]

    def tr(x):
        return x.transpose(-1, -2)

    lw = torch.log2(torch.clamp(w, min=1e-12))
    R, K, V, L, O = (chunks(x) for x in (r, k, v, lw, do))  # pad: w = 1
    C = torch.cumsum(L, dim=3)                       # inclusive sums
    Cx = torch.cat([torch.zeros_like(C[..., :1, :]), C], dim=3)
    E, Z = Cx[..., :CHUNK, :], C[..., -1:, :]        # exclusive; the end
    for x in (E, Z - C):
        assert bool((x <= 0).all())

    # the forward's states entering each chunk (its passes (a), (b))
    dS = mm(tr(K * torch.exp2(Z - C)), V)
    S = torch.zeros((B, H, D, D)) if s0 is None else s0.clone()
    s_in = []
    for c in range(n):
        s_in.append(S)
        S = torch.exp2(Z[:, :, c, 0])[..., None] * S + dS[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    # (a) each chunk's local term; (b) the state gradients, last chunk first
    local = mm(tr(R * torch.exp2(E)), O)
    G = torch.zeros((B, H, D, D)) if ds is None else ds.clone()
    ds_out = [None] * n
    for c in reversed(range(n)):
        ds_out[c] = G
        G = torch.exp2(Z[:, :, c, 0])[..., None] * G + local[:, :, c]
    ds_out = torch.stack(ds_out, dim=2)

    # (c) dA; the score tile's diagonal sub-blocks on the CUDA cores, its
    # cross tiles (transposed) as products, each sub-block row j of A^T
    # one product with do
    uu = u[None, :, None, None, :]
    dA = mm(O, tr(V))
    dd = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]
    t = torch.arange(CHUNK)
    intra = ((t[:, None] // SUB) == (t[None, :] // SUB)) & (
        t[None, :] < t[:, None])
    expo = E[..., :, None, :] - C[..., None, :, :]
    F = torch.exp2(torch.where(intra[..., None], expo, float("-inf")))
    A_in = (torch.einsum("...td,...sd,...tsd->...ts", R, K, F)
            + torch.diag_embed((R * uu * K).sum(-1)))
    dv = torch.empty_like(V)
    for j in range(NSUB):
        Y = Cx[..., (j + 1) * SUB:(j + 1) * SUB + 1, :]
        k_hat = rows(K, j, j + 1) * torch.exp2(Y - rows(C, j, j + 1))
        parts = [tr(A_in[..., j * SUB:(j + 1) * SUB, j * SUB:(j + 1) * SUB])]
        for i in range(j + 1, NSUB):
            r_hat = rows(R, i, i + 1) * torch.exp2(rows(E, i, i + 1) - Y)
            parts.append(mm(k_hat, tr(r_hat)))       # A^T[s in j, t in i]
        k_end = rows(K, j, j + 1) * torch.exp2(Z - rows(C, j, j + 1))
        dv[..., j * SUB:(j + 1) * SUB, :] = (
            mm(torch.cat(parts, dim=-1), O[..., j * SUB:, :])
            + mm(k_end, ds_out))
    # the state terms, and their sums over each sub-block for d log w
    r_state = torch.exp2(E) * mm(O, tr(s_in))
    k_state = torch.exp2(Z - C) * mm(V, tr(ds_out))
    RS, KS = sub_blocks(R * r_state).sum(-2), sub_blocks(K * k_state).sum(-2)
    dr_x, dk_x, case1 = cross_pieces(R, K, dA, E, C, Cx, mm)
    RX, KX = r_state + dr_x, k_state + dk_x
    dr_i, dk_i, pairs = intra_pieces(R, K, dA, chunks(torch.clamp(w, min=1e-12)))
    dr = RX + dr_i + uu * K * dd
    dk = KX + dk_i + uu * R * dd
    # d log w_j, j in sub-block c: the whole decay's term, the r state
    # terms of the sub-blocks after c and the k state terms of those before
    # it, the pairs that span c, then inside c the sums over k KX before j,
    # the intra pairs, and r RX after j
    whole = torch.exp2(Z[..., 0, :]) * (s_in * ds_out).sum(-1)
    base = []
    for c in range(NSUB):
        b = whole
        for i in range(c + 1, NSUB):
            b = b + RS[..., i, :]
        for i in range(c):
            b = b + KS[..., i, :]
        base.append(b + case1[..., c, :])
    base = torch.stack(base, dim=-2)[..., :, None, :]     # (.., 4, 1, D)
    lam = (sub_blocks(prefix_in_sub(K * KX) + pairs) + base).reshape(R.shape)
    lam = lam + suffix_in_sub(R * RX)
    dw = torch.where(w >= 1e-12, unchunk(lam) / w, 0.0)
    du = (sub_blocks(R * K * dd).sum(-2)).sum((0, 2, 3))
    return (unchunk(dr), unchunk(dk), unchunk(dv), dw, du,
            G if s0 is not None else None)


@pytest.mark.parametrize("decay", ["slow", "fast"])
def test_rwkv6_dlogw_pair_split_is_exact(decay):
    """In float64, the kernel's split of d log w_j's pair sum over s < j < t
    (the intra-sub-block pairs, the pairs that span j's whole sub-block, and
    the prefix and suffix sums of k times dk's and r times dr's cross
    terms, those cross terms as products through Y) equals the whole-chunk
    form: each row t's prefix sums over s of dA[t,s] r_t k_s 2^(E_t - C_s),
    summed over the rows t > j."""
    rng = np.random.default_rng(8)
    shape = (1, 2, 3, CHUNK, 64)                     # (B, H, n, c, D)

    def f(*s, sc=1.0):
        return torch.from_numpy(rng.standard_normal(s) * sc)

    R, K, dA = f(*shape, sc=0.5), f(*shape, sc=0.5), f(*shape[:-1], CHUNK)
    lo, hi = (1e-3, 0.05) if decay == "fast" else (0.6, 0.999)
    W = torch.from_numpy(rng.uniform(lo, hi, shape))
    C = torch.cumsum(torch.log2(W), dim=-2)
    Cx = torch.cat([torch.zeros_like(C[..., :1, :]), C], dim=-2)
    E = Cx[..., :CHUNK, :]
    t = torch.arange(CHUNK)
    below = t[None, :] < t[:, None]
    F = torch.exp2(torch.where(below[..., None],
                               E[..., :, None, :] - C[..., None, :, :],
                               float("-inf")))
    X = dA[..., None] * R[..., :, None, :] * K[..., None, :, :] * F
    whole = torch.einsum("tj,...tjd->...jd", below.double(),
                         exclusive_cumsum(X, -2))
    _, _, intra = intra_pieces(R, K, dA, W)
    dr_x, dk_x, case1 = cross_pieces(R, K, dA, E, C, Cx, torch.matmul)
    split = (intra + prefix_in_sub(K * dk_x) + suffix_in_sub(R * dr_x)
             + case1.repeat_interleave(SUB, dim=-2))
    scale = float(whole.abs().max())
    assert scale > 0
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-9,
                               atol=1e-12 * scale)


def grad_shares(ins, mm):
    """Each gradient's worst element's share of its limit (<= 1 holds), the
    emulated backward with products in ``mm`` against the float64 step
    oracle."""
    want = oracle_rwkv6_grads(*ins)
    got = [g for g in rwkv6_bwd_emulated(*(tt(x) for x in ins), mm=mm)
           if g is not None]
    return [float(np.max(np.abs(g.numpy() - x.numpy()) / (
        GRAD_ATOL_RMS * np.sqrt(np.mean(x.numpy() ** 2))
        + GRAD_RTOL * np.abs(x.numpy())))) for g, x in zip(got, want)]


def test_rwkv6_bwd_single_pass_tf32_misses_the_limit():
    """One TF32 pass per product keeps ~11 bits of each operand: the
    emulated backward then leaves the gradient limit that the kernel's
    3xTF32 split holds."""
    ins = rwkv6_inputs(7, 1, 200, 2, "slow", False, False)
    assert max(grad_shares(ins, mm_3xtf32)) <= 1.0
    assert max(grad_shares(ins, mm_tf32)) > 1.0


@pytest.mark.parametrize("B,T,H,decay,carried,with_ds", [
    (2, 70, 2, "slow", True, True),      # ragged T, s0 and dS_T
    (1, 200, 2, "slow", False, False),   # four chunks, ragged
    (1, 130, 2, "clamp", True, True),    # w under the clamp
    (1, 1, 2, "slow", True, True),       # T = 1
])
def test_rwkv6_plain_grads_match_jax(B, T, H, decay, carried, with_ds):
    """Autograd of ``rwkv6_scan_plain`` (with the cotangents of o and of
    the final state) against ``jax.grad`` of ``rwkv6_chunked_jnp``: every
    input's gradient, s0's included; zero gradient under the clamp."""
    ins = rwkv6_inputs(1, B, T, H, decay, carried, with_ds)
    want = jax_rwkv6_grads(*(None if x is None else jnp.asarray(x)
                             for x in ins))
    got = RS.rwkv6_scan_bwd_plain(*(tt(x) for x in ins))
    got = [g for g in got if g is not None]
    assert len(got) == len(want)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert_grad_close(g.numpy(), x, name)
    if decay == "clamp":
        assert bool((got[3][torch.from_numpy(ins[3] < 1e-12)] == 0).all())


RWKV6_BWD_DESIGN_CASES = [  # B, T, H, decay, carried-in s0, dS_T
    (2, 70, 2, "slow", True, True),
    (1, 200, 2, "slow", False, False),
    (1, 130, 2, "clamp", True, True),
    (1, 1, 2, "slow", True, True),
    (1, 64, 2, "slow", True, False),     # one whole chunk
    # fast decays: the chunked forms overflow, the emulation stays finite
    (1, 190, 2, "fast", True, True),
]


@pytest.mark.parametrize("B,T,H,decay,carried,with_ds",
                         RWKV6_BWD_DESIGN_CASES)
def test_rwkv6_bwd_design_matches_step_oracle(B, T, H, decay, carried,
                                              with_ds):
    """The backward kernel's passes against float64 autograd of the step
    recurrence at the card's limit."""
    ins = rwkv6_inputs(2, B, T, H, decay, carried, with_ds)
    want = oracle_rwkv6_grads(*ins)
    got = [g for g in rwkv6_bwd_emulated(*(tt(x) for x in ins))
           if g is not None]
    assert len(got) == len(want)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert_grad_close(g.numpy(), x.numpy(), name)
    if decay == "fast":
        # the reference's chunk-128 form (and the plain version, op for op)
        # overflows here: its gradients are not finite
        plain = RS.rwkv6_scan_bwd_plain(*(tt(x) for x in ins))
        assert not all(bool(torch.isfinite(g).all())
                       for g in plain if g is not None)
        ref = jax_rwkv6_grads(*(None if x is None else jnp.asarray(x)
                                for x in ins))
        assert not all(bool(np.isfinite(np.asarray(g)).all()) for g in ref)


# ------------------------------------------------------------- rglru --
def rglru_inputs(seed, B, T, d, carried, decay):
    """log_a, b, h0 (or None), dy, f32 numpy; "model" decays as the
    model's -8 softplus(1) sigmoid(.), "slow" as -|N(0,1)|/10 (a chunk's
    carry keeps a share of its h)."""
    rng = np.random.default_rng(seed)
    shape = (B, T, d)
    if decay == "model":
        gate = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
        log_a = -8.0 * np.log1p(np.e) * gate
    else:
        log_a = -np.abs(rng.standard_normal(shape)) * 0.1
    f32 = np.float32
    return (log_a.astype(f32), rng.standard_normal(shape).astype(f32),
            rng.standard_normal((B, d)).astype(f32) if carried else None,
            rng.standard_normal(shape).astype(f32))


def oracle_rglru_grads(log_a, b, h0, dy):
    ins = [torch.from_numpy(x).double().requires_grad_()
           for x in (log_a, b) + ((h0,) if h0 is not None else ())]
    out = RG.rglru_scan_plain(*ins)
    return torch.autograd.grad(out, ins, torch.from_numpy(dy).double())


def rglru_bwd_emulated(log_a, b, h0, dy):
    """The backward entry of csrc/rglru_scan.cu in f32: the carry c_t =
    a_t g_t runs backward as c = a (dy + c) on the kernel's time chunks;
    pass 1 the aggregates (product of a, carry from 0) of every chunk but
    the first, pass 2 the carry entering each chunk from the chunks after
    it, then the chunk rescanned backward.  (dlog_a, db, dh0 or None)."""
    B, T, d = log_a.shape
    h = RG.rglru_scan_plain(log_a, b, h0)
    h_prev = torch.cat([(torch.zeros((B, 1, d)) if h0 is None
                         else h0[:, None]), h[:, :-1]], dim=1)
    a = torch.exp(log_a)
    len_ = RG.time_chunk(T)
    n = -(-T // len_)

    def walk(t0, t1, c, out=None):
        P = torch.ones((B, d))
        for t in range(t1 - 1, t0 - 1, -1):
            g = dy[:, t] + c
            if out is not None:
                out[0][:, t] = (g * h_prev[:, t]) * a[:, t]
                out[1][:, t] = g
            c = a[:, t] * g
            P = a[:, t] * P
        return P, c

    aggs = {j: walk(j * len_, min(T, (j + 1) * len_), torch.zeros((B, d)))
            for j in range(1, n)}
    dla, db = torch.empty_like(log_a), torch.empty_like(log_a)
    dh0 = None
    for j in range(n):
        c = torch.zeros((B, d))
        for m in range(n - 1, j, -1):
            P, cl = aggs[m]
            c = P * c + cl
        _, c = walk(j * len_, min(T, (j + 1) * len_), c, (dla, db))
        if j == 0 and h0 is not None:
            dh0 = c
    return dla, db, dh0


@pytest.mark.parametrize("B,T,d,carried,decay", [
    (2, 70, 48, True, "model"),
    (1, 1, 48, True, "model"),           # T = 1
    (1, 100, 48, False, "slow"),
])
def test_rglru_plain_grads_match_jax(B, T, d, carried, decay):
    """Autograd of ``rglru_scan_plain`` against ``jax.grad`` of
    ``rglru_scan_jnp`` (its associative scan), h0's gradient included."""
    log_a, b, h0, dy = rglru_inputs(3, B, T, d, carried, decay)

    def loss(log_a, b, h0):
        return jnp.sum(rglru_scan_jnp(log_a, b, h0) * dy)

    argnums = (0, 1, 2) if carried else (0, 1)
    want = jax.grad(loss, argnums=argnums)(jnp.asarray(log_a),
                                           jnp.asarray(b),
                                           None if h0 is None
                                           else jnp.asarray(h0))
    got = [g for g in RG.rglru_scan_bwd_plain(tt(log_a), tt(b), tt(h0),
                                              tt(dy)) if g is not None]
    assert len(got) == len(want)
    for name, g, x in zip(("dlog_a", "db", "dh0"), got, want):
        assert_grad_close(g.numpy(), x, name)


@pytest.mark.parametrize("B,T,d,carried,decay", [
    (2, 300, 40, True, "model"),         # ten chunks, h0
    (1, 2100, 8, False, "slow"),         # past 64 chunks: longer chunks
    (1, 33, 8, True, "slow"),            # one step past a chunk
    (1, 1, 8, True, "model"),
])
def test_rglru_bwd_design_matches_step_oracle(B, T, d, carried, decay):
    args = rglru_inputs(4, B, T, d, carried, decay)
    want = oracle_rglru_grads(*args)
    got = [g for g in rglru_bwd_emulated(*(tt(x) for x in args))
           if g is not None]
    assert len(got) == len(want)
    for name, g, x in zip(("dlog_a", "db", "dh0"), got, want):
        assert_grad_close(g.numpy(), x.numpy(), name)


# ------------------------------------------- the Functions' wiring --
def test_rwkv6_fn_carries_the_plain_gradient_on_cpu():
    """``Rwkv6ScanFn`` (what a CUDA call that requires grad goes through)
    on CPU tensors: the plain forward and its autograd backward, bit for
    bit, with s0 and both outputs' cotangents, and with o's alone."""
    r, k, v, w, u, s0, do, ds = (tt(x) for x in rwkv6_inputs(
        5, 2, 70, 2, "slow", True, True))
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    o, S = RS.Rwkv6ScanFn.apply(*leaves)
    assert o.grad_fn is not None
    got = torch.autograd.grad((o, S), leaves, (do, ds))
    want = RS.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, do, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    o, _ = RS.Rwkv6ScanFn.apply(*leaves[:5], None)
    got = torch.autograd.grad(o, leaves[:5], do)
    want = RS.rwkv6_scan_bwd_plain(r, k, v, w, u, None, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:5]))


def test_rglru_fn_carries_the_plain_gradient_on_cpu():
    log_a, b, h0, dy = (tt(x) for x in rglru_inputs(6, 2, 70, 16, True,
                                                    "model"))
    leaves = [x.clone().requires_grad_() for x in (log_a, b, h0)]
    out = RG.RglruScanFn.apply(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, dy)
    want = RG.rglru_scan_bwd_plain(log_a, b, h0, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


if __name__ == "__main__":
    # Each gradient's worst share of its limit against the float64 step
    # oracle, the emulated rwkv6 backward in the 3xTF32 split and in one
    # TF32 pass, for each design case above:
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_scan_grad.py
    for case in RWKV6_BWD_DESIGN_CASES:
        ins = rwkv6_inputs(2, *case)
        print("rwkv6 bwd B={} T={} H={} decay={} s0={} dS_T={}".format(*case),
              "3xTF32 " + "/".join(f"{x:.3f}" for x in grad_shares(
                  ins, mm_3xtf32)) + "; one TF32 pass " + "/".join(
                  f"{x:.2f}" for x in grad_shares(ins, mm_tf32)))
