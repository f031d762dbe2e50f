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
step's own decay -- and held to the limit the card holds the kernels to.
Inputs are made with numpy from a seed."""
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

CHUNK = RS.KERNEL_CHUNK      # 64, the kernels' chunk
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
def rwkv6_bwd_emulated(r, k, v, w, u, s0, do, ds):
    """The passes of csrc/rwkv6_scan_bwd.cu (and, for the states entering
    each chunk, csrc/rwkv6_scan.cu's) in f32 on (B,T,H,D) tensors: (dr, dk,
    dv, dw, du, ds0 or None).  Asserts that every exponent formed is <= 0."""
    B, T, H, D = r.shape
    n = -(-T // CHUNK)
    pad = n * CHUNK - T

    def chunks(x):                                   # (B, H, n, c, D)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, CHUNK, H, D).permute(0, 3, 1, 2, 4)

    def unchunk(x):
        return x.permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, D)[:, :T]

    lw = torch.log2(torch.clamp(w, min=1e-12))
    R, K, V, L, O = (chunks(x) for x in (r, k, v, lw, do))  # pad: w = 1
    C = torch.cumsum(L, dim=3)                       # inclusive sums
    Cx = torch.cat([torch.zeros_like(C[..., :1, :]), C], dim=3)
    E, Z = Cx[..., :CHUNK, :], C[..., -1:, :]        # exclusive; the end
    t = torch.arange(CHUNK)
    below = t[None, :] < t[:, None]                  # s < t
    expo = E[..., :, None, :] - C[..., None, :, :]   # (.., t, s, D)
    for x in (E, Z - C, expo[..., below, :]):
        assert bool((x <= 0).all())
    F = torch.exp2(torch.where(below[..., None], expo, float("-inf")))

    # the forward's states entering each chunk (its passes (a), (b))
    dS = (K * torch.exp2(Z - C)).transpose(-1, -2) @ V
    S = torch.zeros((B, H, D, D)) if s0 is None else s0.clone()
    s_in = []
    for c in range(n):
        s_in.append(S)
        S = torch.exp2(Z[:, :, c, 0])[..., None] * S + dS[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    # (a) each chunk's local term; (b) the state gradients, last chunk first
    local = (R * torch.exp2(E)).transpose(-1, -2) @ O
    G = torch.zeros((B, H, D, D)) if ds is None else ds.clone()
    ds_out = [None] * n
    for c in reversed(range(n)):
        ds_out[c] = G
        G = torch.exp2(Z[:, :, c, 0])[..., None] * G + local[:, :, c]
    ds_out = torch.stack(ds_out, dim=2)

    # (c) A, dA; dv, dr, dk; the decay's gradient; du
    uu = u[None, :, None, None, :]
    A = (torch.einsum("...td,...sd,...tsd->...ts", R, K, F)
         + torch.diag_embed((R * uu * K).sum(-1)))
    dA_all = O @ V.transpose(-1, -2)
    dA = torch.where(below, dA_all, 0.0)
    dd = torch.diagonal(dA_all, dim1=-2, dim2=-1)[..., None]
    dv = A.transpose(-1, -2) @ O + (K * torch.exp2(Z - C)) @ ds_out
    r_state = torch.exp2(E) * (O @ s_in.transpose(-1, -2))
    k_state = torch.exp2(Z - C) * (V @ ds_out.transpose(-1, -2))
    X = dA[..., None] * R[..., :, None, :] * K[..., None, :, :] * F
    dr = r_state + torch.einsum("...ts,...sd,...tsd->...td", dA, K, F)
    dk = k_state + torch.einsum("...ts,...td,...tsd->...sd", dA, R, F)
    # d log w_j: the whole decay's term, the reverse sum over t > j of r's
    # state terms, the forward sum over s < j of k's, and the pairs
    # s < j < t as the kernel walks them (prefix sums over s of each row t,
    # summed over the rows t > j)
    whole = torch.exp2(Z[..., 0, :]) * (s_in * ds_out).sum(-1)
    gE, gC = R * r_state, K * k_state
    rev = torch.flip(torch.cumsum(torch.flip(gE, [3]), 3), [3]) - gE
    fwd = torch.cumsum(gC, 3) - gC
    pre = torch.cumsum(X, dim=-2) - X                # (.., t, j, D): s < j
    pairs = torch.einsum("tj,...tjd->...jd", below.float(), pre)
    lam = unchunk(whole[..., None, :] + rev + fwd + pairs)
    dw = torch.where(w >= 1e-12, lam / w, 0.0)
    du = (R * K * dd).sum((0, 2, 3))
    dr, dk = dr + uu * K * dd, dk + uu * R * dd
    return (unchunk(dr), unchunk(dk), unchunk(dv), dw, du,
            G if s0 is not None else None)


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


@pytest.mark.parametrize("B,T,H,decay,carried,with_ds", [
    (2, 70, 2, "slow", True, True),
    (1, 200, 2, "slow", False, False),
    (1, 130, 2, "clamp", True, True),
    (1, 1, 2, "slow", True, True),
    (1, 64, 2, "slow", True, False),     # one whole chunk
    # fast decays: the chunked forms overflow, the emulation stays finite
    (1, 190, 2, "fast", True, True),
])
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
