"""RWKV-6 WKV scan: the Hopper kernel, its plain version, its count.

Replaces the TPU kernel ``rwkv6_scan`` (``repro/kernels/rwkv6_scan.py``,
``_rwkv6_kernel``) and ``rwkv6_scan_with_state``; the JAX model computes
the same function as ``rwkv6_chunked_jnp``.  Per (batch, head), with a
(D x D) state S, decay w_t in (0, 1] and bonus u::

    o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The CUDA source is ``csrc/rwkv6_scan.cu``, the chunked form in three
grid launches per call on 64-step chunks (``KERNEL_CHUNK``), reading the
(B, T, H, D) inputs in place and masking a ragged last chunk as identity
steps:

1. per (chunk, 64 state columns, head, batch): the chunk's decay and its
   state delta k_end^T v, into scratch that the wrapper allocates;
2. per (4 state entries, head, batch): the n chunks in order, which turns
   each delta into the state entering its chunk and writes the final
   state;
3. per (chunk, 64 output columns, head, batch): o from the state entering
   the chunk and the chunk's causal score tile.

On the H100 the function is bound by bytes, narrowly (its f32 products at
the kernel's chunk take almost as long at the CUDA cores' f32 peak).  The
chunk-parallel form gives 640 blocks at rwkv6-3b's prefill where walking
the chunks in turn gave 160, and the products run on the tensor cores in
the 3xTF32 split (three TF32 products per f32 one, ~22 bits of each
operand kept; a single TF32 pass misses the port's 1e-4 limit).  Every
decay factor is <= 1 (see the source note), so the kernel stays finite
where the reference's ``k * exp(-cum)`` overflows, and every sum is taken
in a fixed order, so two calls give the same bits.
``rwkv6_scan.launches`` counts calls, each of them three grid launches.

The gradient: the JAX package trains by differentiating
``rwkv6_chunked_jnp``; here that call is the kernel, so ``Rwkv6ScanFn``
saves the forward's scratch (the state entering each chunk), and its
backward launches ``csrc/rwkv6_scan_bwd.cu``
(``rwkv6_scan_bwd``, D 64): the state gradients entering each chunk, last
chunk first, then dr, dk, dv, dw and du chunk by chunk (see the source
note), with every exponent <= 0 as in the forward.  Like the forward it
cuts each chunk into 16-step sub-blocks: pairs inside one take their decay
on the CUDA cores, pairs across two factor through a cumulative sum
between them into products, and every product (the state terms, dA, A^T
do, the cross terms) runs on the tensor cores in the 3xTF32 split.  On an
NVIDIA H100 80GB HBM3 (700 W) it takes 0.56 ms of device time at
rwkv6-3b's training shape (B 4, T 1024, H 40), 20% of its bytes bound
(0.113 ms).  ``rwkv6_scan_bwd.launches`` counts its calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _meta

HEAD_DIMS = (64, 128)
BWD_HEAD_DIMS = (64,)   # head dims of the backward kernel (rwkv6-3b's)
RWKV_CHUNK = 128        # chunk of ``rwkv6_chunked_jnp`` (layers.py RWKV_CHUNK)
KERNEL_CHUNK = 64       # time steps per chunk of csrc/rwkv6_scan.cu


def rwkv6_scan_plain(r, k, v, w, u, s0=None):
    """The chunked form of ``repro.models.layers.rwkv6_chunked_jnp`` at its
    default chunk, op for op: r, k, v, w (B,T,H,D) f32, u (H,D), s0
    (B,H,D,D) or None; returns (o (B,T,H,D), final state (B,H,D,D)), both
    f32."""
    B, T, H, D = r.shape
    chunk = RWKV_CHUNK
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    if T == 0:
        return r.new_zeros((B, 0, H, D), dtype=torch.float32), S
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    rc = r.reshape(B, n, chunk, H, D)
    kc = k.reshape(B, n, chunk, H, D)
    vc = v.reshape(B, n, chunk, H, D)
    logw = torch.log(torch.clamp(w, min=1e-12)).reshape(B, n, chunk, H, D)
    uf = u.float()
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    o = r.new_empty((B, n * chunk, H, D), dtype=torch.float32)
    for c in range(n):
        rb, kb, vb, lwb = rc[:, c], kc[:, c], vc[:, c], logw[:, c]
        cum = torch.cumsum(lwb, dim=1)                 # inclusive decay sums
        r_dec = rb * torch.exp(cum - lwb)              # decay up to t-1
        o_state = torch.einsum("bchd,bhde->bche", r_dec, S)
        kin = kb * torch.exp(-cum)
        att = torch.einsum("bchd,bshd->bhcs", r_dec, kin)
        att = torch.where(causal, att, 0.0)
        o_intra = torch.einsum("bhcs,bshd->bchd", att, vb)
        o_diag = torch.einsum("bchd,hd,bchd->bch", rb, uf, kb)[..., None] * vb
        dec_all = torch.exp(cum[:, -1])                # (B, H, D)
        k_end = kb * torch.exp(cum[:, -1][:, None] - cum)
        S = S * dec_all[..., None] + torch.einsum("bchd,bche->bhde",
                                                  k_end, vb)
        o[:, c * chunk:(c + 1) * chunk] = o_state + o_intra + o_diag
    return o[:, :T], S


def rwkv6_scan_bwd_plain(r, k, v, w, u, s0, do, ds_final=None):
    """(dr, dk, dv, dw, du, ds0 or None): autograd of ``rwkv6_scan_plain``
    with the cotangents ``do`` of o and ``ds_final`` (or none) of the final
    state."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        if s0 is not None:
            ins.append(s0.detach().requires_grad_())
        o, state = rwkv6_scan_plain(*ins[:5], ins[5] if s0 is not None
                                    else None)
        outs, cots = [o], [do]
        if ds_final is not None:
            outs.append(state)
            cots.append(ds_final)
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, ins)]
    return (*grads[:5], grads[5] if s0 is not None else None)


def work(B: int, T: int, H: int, D: int):
    """((operations, bytes) of the forward, of the backward) of the
    chunked WKV6 at the kernel's chunk (``chip_smoke.py``'s
    ``rwkv6_ops`` / ``rwkv6_bwd_ops``): per step and head 4 D^2 forward
    (8 D^2 backward) for the state terms, per causal (t, s) pair of a
    chunk 4 D forward (10 D backward); r, k, v, w in and o, the state out
    once (forward), their gradients too (backward), in f32."""
    full, rest = divmod(T, KERNEL_CHUNK)
    pairs = (full * KERNEL_CHUNK * (KERNEL_CHUNK + 1) // 2
             + rest * (rest + 1) // 2)
    x, state = B * T * H * D, B * H * D * D
    fwd = (B * H * (4 * D * D * T + 4 * D * pairs), 4 * (5 * x + state))
    bwd = (B * H * (8 * D * D * T + 10 * D * pairs), 4 * (9 * x + 2 * state))
    return fwd, bwd


def _check(r, k, v, w, u, s0):
    """The inputs' tensors (s0 left out when None); raises on shapes that do
    not match."""
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)}")
    B, T, H, D = r.shape
    if tuple(u.shape) != (H, D) or (
            s0 is not None and tuple(s0.shape) != (B, H, D, D)):
        raise ValueError(f"u{tuple(u.shape)} / s0"
                         f"{None if s0 is None else tuple(s0.shape)} do not "
                         f"match r{tuple(r.shape)}")
    return [t for t in (r, k, v, w, u, s0) if t is not None]


def _check_cuda(name, tensors, head_dims):
    r = tensors[0]
    if not (r.is_cuda and all(t.device == r.device for t in tensors)):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device "
                         "(or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: float32 inputs; got "
                        f"{[str(t.dtype) for t in tensors]}")
    D = r.shape[3]
    if D not in head_dims:
        raise NotImplementedError(
            f"{name} kernel: head_dim in {head_dims}; got D={D}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned (the kernel moves 16 bytes at a time)")


def _aligned(x):
    """x contiguous and 16-byte aligned (a copy where it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class Rwkv6ScanFn(torch.autograd.Function):
    """``rwkv6_scan`` with a gradient: the forward launches the kernel and
    saves its scratch (the states entering the chunks), the backward
    launches the backward kernel (``rwkv6_scan_bwd``).  CPU tensors
    take the plain versions on both sides."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            o, state = rwkv6_scan_plain(r, k, v, w, u, s0)
            scratch = None
        else:
            o, state, scratch = _forward_kernel(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0, scratch)
        return o, state

    @staticmethod
    def backward(ctx, do, ds_final):
        r, k, v, w, u, s0, scratch = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return rwkv6_scan_bwd(r, k, v, w, u, s0, _aligned(do),
                              None if ds_final is None
                              else _aligned(ds_final), s_in=scratch)


def rwkv6_scan(r, k, v, w, u, s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over a whole sequence: r, k, v, w (B,T,H,D) float32, u (H,D)
    float32, optional initial state s0 (B,H,D,D) float32.  Returns (o
    (B,T,H,D), final state (B,H,D,D)), float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.  Where autograd
    records a CUDA call (an input requires grad), it goes through
    ``Rwkv6ScanFn`` and the backward kernel, or raises at a head dim the
    backward kernel does not take (``BWD_HEAD_DIMS``)."""
    tensors = _check(r, k, v, w, u, s0)
    if _meta.is_meta(*tensors):
        B, T, H, D = r.shape
        return _meta.run("rwkv6_scan", (r, k, v, w, u, s0),
                         [(r.shape, r.dtype), ((B, H, D, D), r.dtype)],
                         *work(B, T, H, D))
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_scan_plain(r, k, v, w, u, s0)
    _check_cuda("rwkv6_scan", tensors, HEAD_DIMS)
    if _build.wants_grad(*tensors):
        D = r.shape[3]
        if D not in BWD_HEAD_DIMS:
            _build.refuse_grad("rwkv6_scan", *tensors, why=(
                f" at head_dim {D} (only {BWD_HEAD_DIMS})"))
        return Rwkv6ScanFn.apply(r, k, v, w, u, s0)
    return _forward_kernel(r, k, v, w, u, s0)[:2]


def _forward_kernel(r, k, v, w, u, s0):
    """Launch the forward kernel on checked CUDA inputs, counting it: (o,
    final state, scratch), the scratch's first B*H*n*D*D floats the state
    entering each chunk."""
    B, T, H, D = r.shape
    o = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    # per chunk: its state delta, then the state entering it (D*D), and its
    # decay (D)
    n = -(-T // KERNEL_CHUNK)
    scratch = torch.empty(B * H * n * (D * D + D), dtype=torch.float32,
                          device=r.device)
    if B == 0 or H == 0:
        return o, state, scratch
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), state.data_ptr(), scratch.data_ptr(), B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return o, state, scratch


rwkv6_scan.launches = 0    # calls (3 grid launches each) since the last reset


def rwkv6_scan_bwd(r, k, v, w, u, s0, do, ds_final=None, *, s_in=None):
    """The gradient (dr, dk, dv, dw, du, ds0 or None) of ``rwkv6_scan(r, k,
    v, w, u, s0)`` from the cotangents ``do`` (B,T,H,D) of o and
    ``ds_final`` (B,H,D,D, or None for zero) of the final state.  CPU
    tensors take the plain version (autograd of ``rwkv6_scan_plain``);
    CUDA tensors launch ``csrc/rwkv6_scan_bwd.cu`` (D 64; four grid
    launches, no atomics, the same bits on every call) or raise, and need
    ``s_in``: the forward kernel's scratch, as ``_forward_kernel`` returns
    it."""
    tensors = _check(r, k, v, w, u, s0)
    if do.shape != r.shape or (ds_final is not None and tuple(
            ds_final.shape) != (r.shape[0], r.shape[2], r.shape[3],
                                r.shape[3])):
        raise ValueError(f"rwkv6_scan_bwd: do{tuple(do.shape)} / ds_final"
                         f"{None if ds_final is None else tuple(ds_final.shape)}"
                         f" do not match r{tuple(r.shape)}")
    extra = [t for t in (do, ds_final) if t is not None]
    if all(t.device.type == "cpu" for t in tensors + extra):
        return rwkv6_scan_bwd_plain(r, k, v, w, u, s0, do, ds_final)
    if s_in is None:
        raise ValueError("rwkv6_scan_bwd: CUDA inputs need the forward "
                         "kernel's scratch")
    _check_cuda("rwkv6_scan_bwd", tensors + extra + [s_in], BWD_HEAD_DIMS)
    B, T, H, D = r.shape
    n = -(-T // KERNEL_CHUNK)
    if s_in.numel() < B * H * n * D * D:
        raise ValueError("rwkv6_scan_bwd: the forward's scratch is too small")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if B == 0 or H == 0:
        du.zero_()
        return dr, dk, dv, dw, du, ds0
    # per chunk: the local state term, then dS_out (D*D); its decay and its
    # share of du (D each)
    bwd_scratch = torch.empty(B * H * n * (D * D + 2 * D),
                              dtype=torch.float32, device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), do.data_ptr(),
            None if ds_final is None else ds_final.data_ptr(),
            s_in.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            None if ds0 is None else ds0.data_ptr(), bwd_scratch.data_ptr(),
            B, T, H, D, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "rwkv6_scan_bwd")
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


rwkv6_scan_bwd.launches = 0    # calls (4 grid launches each) since the last reset
