"""RG-LRU scan: the Hopper kernel, its plain version, its count.

Replaces the TPU kernel ``rglru_scan`` (``repro/kernels/rglru_scan.py``,
``_rglru_kernel``); the JAX model computes the same function as
``rglru_scan_jnp``.  Elementwise over channels, with an optional initial
state h0::

    h_t = exp(log_a_t) * h_{t-1} + b_t

The CUDA source is ``csrc/rglru_scan.cu``, split over time as well as
channels, in two grid launches per call on chunks of ``time_chunk(T)``
steps: the first writes each chunk's aggregate (the product of its decays
and its h from zero) into scratch that the wrapper allocates; the second
composes the h entering each chunk from the aggregates before it, in chunk
order, and rescans the chunk from there with the plain version's step.
Neighbouring threads take neighbouring channels, 16 bytes a thread where d
allows; steps past T are identity steps.

On the H100 the function is bound by bytes (log_a and b read once, h
written once).  One thread per channel walking all T steps kept too few
loads in flight for that; the split multiplies the threads by T / chunk.
``rglru_scan.launches`` counts calls, each of them two grid launches.

The gradient: the JAX package trains by differentiating ``rglru_scan_jnp``;
here that call is the kernel, so ``RglruScanFn`` saves the forward's h and
its backward launches the backward kernel of the same source
(``rglru_scan_bwd``): with a_t = exp(log_a_t) and g_t the whole gradient of
h_t, g_t = dy_t + a_{t+1} g_{t+1}, db = g, dlog_a_t = g_t h_{t-1} a_t and
dh0 = a_0 g_0 -- the forward's recurrence run backward, on the forward's
chunks, with the same two passes in reverse chunk order.  Bound by bytes
too (log_a, h, dy read once, dlog_a and db written once).
``rglru_scan_bwd.launches`` counts its calls.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _meta

CHUNK = 32          # time steps per chunk of the kernel, up to T = 32 * 64
MAX_CHUNKS = 64     # beyond that, longer chunks: the carry loop stays short


def time_chunk(T: int) -> int:
    """Steps per time chunk of the kernel at sequence length T."""
    return max(CHUNK, -(-T // MAX_CHUNKS))


def rglru_scan_plain(log_a, b, h0=None):
    """The recurrence one step at a time, in the style of
    ``repro.kernels.ref.rglru_scan_ref``: log_a, b (B,T,d) f32, h0 (B,d) or
    None; returns every h (B,T,d), f32."""
    B, T, d = log_a.shape
    h = (torch.zeros((B, d), dtype=torch.float32, device=log_a.device)
         if h0 is None else h0.float())
    out = torch.empty((B, T, d), dtype=torch.float32, device=log_a.device)
    for t in range(T):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_plain_chunked(log_a, b, h0=None, chunk: int = 512):
    """``rglru_scan_plain`` split over time as the kernel splits it, every
    chunk of ``chunk`` steps at once: each chunk's steps from h = 0 with
    the product of its decays, the h entering each chunk composed from
    those in chunk order, then each chunk's steps again from there.  Within
    a chunk the steps are the plain version's; the carried h differs from
    it by the rounding of the composed products.  2 * chunk + T / chunk
    steps of whole-tensor ops where the plain version takes T: the plain
    version at T = 524288 (tests/test_torch_long_500k.py)."""
    B, T, d = log_a.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    la, bb = log_a.float(), b.float()
    if pad:    # identity steps past T
        la = torch.cat([la, la.new_zeros((B, pad, d))], 1)
        bb = torch.cat([bb, bb.new_zeros((B, pad, d))], 1)
    la = la.reshape(B, n, chunk, d)
    bb = bb.reshape(B, n, chunk, d)
    h = la.new_zeros((B, n, d))
    P = la.new_ones((B, n, d))
    for t in range(chunk):
        a = torch.exp(la[:, :, t])
        h = a * h + bb[:, :, t]
        P = P * a
    carry = (la.new_zeros((B, d)) if h0 is None else h0.float())
    h_in = torch.empty_like(h)
    for j in range(n):
        h_in[:, j] = carry
        carry = P[:, j] * carry + h[:, j]
    out = torch.empty_like(la)
    h = h_in
    for t in range(chunk):
        h = torch.exp(la[:, :, t]) * h + bb[:, :, t]
        out[:, :, t] = h
    return out.reshape(B, n * chunk, d)[:, :T]


def rglru_scan_bwd_plain(log_a, b, h0, dy):
    """(dlog_a, db, dh0 or None): autograd of ``rglru_scan_plain``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (log_a, b)]
        if h0 is not None:
            ins.append(h0.detach().requires_grad_())
        out = rglru_scan_plain(*ins)
        grads = torch.autograd.grad(out, ins, dy)
    return grads[0], grads[1], grads[2] if h0 is not None else None


def _check(log_a, b, h0):
    """The inputs' tensors (h0 left out when None); raises on shapes that
    do not match."""
    if log_a.ndim != 3 or log_a.shape != b.shape:
        raise ValueError(f"bad shapes log_a{tuple(log_a.shape)} "
                         f"b{tuple(b.shape)}")
    B, T, d = log_a.shape
    if h0 is not None and tuple(h0.shape) != (B, d):
        raise ValueError(f"h0{tuple(h0.shape)} does not match "
                         f"log_a{tuple(log_a.shape)}")
    return [t for t in (log_a, b, h0) if t is not None]


def _check_cuda(name, tensors):
    if not (tensors[0].is_cuda and all(t.device == tensors[0].device
                                       for t in tensors)):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device "
                         "(or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: float32 inputs; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


class RglruScanFn(torch.autograd.Function):
    """``rglru_scan`` with a gradient: the forward launches the kernel and
    saves its h, the backward launches the backward kernel
    (``rglru_scan_bwd``).  CPU tensors take the plain versions on both
    sides."""

    @staticmethod
    def forward(ctx, log_a, b, h0):
        if log_a.device.type == "cpu":
            out = rglru_scan_plain(log_a, b, h0)
        else:
            out = _forward_kernel(log_a, b, h0)
        ctx.save_for_backward(log_a, b, h0, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        log_a, b, h0, out = ctx.saved_tensors
        return rglru_scan_bwd(log_a, b, h0, out, dy.contiguous())


def rglru_scan(log_a, b, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All h of h_t = exp(log_a_t) * h_{t-1} + b_t: log_a, b (B,T,d)
    float32, optional h0 (B,d) float32 (zeros when None); returns (B,T,d)
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.  Where autograd records a CUDA call (an input requires
    grad), it goes through ``RglruScanFn`` and the backward kernel."""
    tensors = _check(log_a, b, h0)
    if _meta.is_meta(*tensors):
        # 3 operations a step and channel forward, 5 backward; each input
        # read and each output written once
        n = log_a.numel()
        return _meta.run("rglru_scan", (log_a, b, h0),
                         [(log_a.shape, log_a.dtype)], (3 * n, 12 * n),
                         (5 * n, 24 * n))[0]
    if all(t.device.type == "cpu" for t in tensors):
        return rglru_scan_plain(log_a, b, h0)
    _check_cuda("rglru_scan", tensors)
    if _build.wants_grad(*tensors):
        return RglruScanFn.apply(log_a, b, h0)
    return _forward_kernel(log_a, b, h0)


def _forward_kernel(log_a, b, h0):
    """Launch the forward kernel on checked CUDA inputs, counting it."""
    if log_a.numel() == 0:
        return torch.empty_like(log_a)
    out = run_kernel(log_a, b, h0, time_chunk(log_a.shape[1]))
    rglru_scan.launches += 1
    return out


def run_kernel(log_a, b, h0, chunk: int) -> torch.Tensor:
    """The kernel's two passes at ``chunk`` steps per time chunk, on inputs
    that ``rglru_scan`` has checked; returns (B,T,d).  Counts nothing
    (``_forward_kernel`` counts its calls); ``profile_port.py`` sweeps
    ``chunk`` through it."""
    B, T, d = log_a.shape
    out = torch.empty_like(log_a)
    n = -(-T // chunk)
    # the aggregates of every chunk but the last: decay products, then h
    scratch = torch.empty(2 * B * (n - 1) * d, dtype=torch.float32,
                          device=log_a.device)
    lib = _build.load()
    with torch.cuda.device(log_a.device):
        err = lib.rglru_scan_launch(
            log_a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, T, d, chunk,
            torch.cuda.current_stream(log_a.device).cuda_stream)
    _build.check(err, "rglru_scan")
    return out


rglru_scan.launches = 0    # calls (2 grid launches each) since the last reset


def rglru_scan_bwd(log_a, b, h0, h, dy):
    """The gradient (dlog_a, db, dh0 or None) of ``rglru_scan(log_a, b,
    h0)`` from its output ``h`` and the output's gradient ``dy`` (B,T,d).
    CPU tensors take the plain version (autograd of ``rglru_scan_plain``,
    which reads b and not h); CUDA tensors launch the backward kernel
    (which reads h and not b) or raise."""
    tensors = _check(log_a, b, h0)
    if h.shape != log_a.shape or dy.shape != log_a.shape:
        raise ValueError(f"rglru_scan_bwd: h{tuple(h.shape)}, "
                         f"dy{tuple(dy.shape)} do not match "
                         f"log_a{tuple(log_a.shape)}")
    if all(t.device.type == "cpu" for t in tensors + [h, dy]):
        return rglru_scan_bwd_plain(log_a, b, h0, dy)
    _check_cuda("rglru_scan_bwd", tensors + [h, dy])
    B, T, d = log_a.shape
    dla, db = torch.empty_like(log_a), torch.empty_like(log_a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if log_a.numel() == 0:
        if dh0 is not None:
            dh0.zero_()
        return dla, db, dh0
    chunk = time_chunk(T)
    n = -(-T // chunk)
    scratch = torch.empty(2 * B * (n - 1) * d, dtype=torch.float32,
                          device=log_a.device)
    lib = _build.load()
    with torch.cuda.device(log_a.device):
        err = lib.rglru_scan_bwd_launch(
            log_a.data_ptr(), h.data_ptr(),
            None if h0 is None else h0.data_ptr(), dy.data_ptr(),
            dla.data_ptr(), db.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), scratch.data_ptr(),
            B, T, d, chunk, torch.cuda.current_stream(log_a.device).cuda_stream)
    _build.check(err, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return dla, db, dh0


rglru_scan_bwd.launches = 0    # calls (2 grid launches each) since the last reset
