"""RWKV-6 WKV scan: the Hopper kernel, its plain version, its count.

Replaces the TPU kernel ``rwkv6_scan`` (``repro/kernels/rwkv6_scan.py``,
``_rwkv6_kernel``) and ``rwkv6_scan_with_state``; the JAX model computes
the same function as ``rwkv6_chunked_jnp``.  Per (batch, head), with a
(D x D) state S, decay w_t in (0, 1] and bonus u::

    o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The CUDA source is ``csrc/rwkv6_scan.cu``: one thread block per (16 state
columns, head, batch) loops over 64-step chunks with its state columns in
shared memory, reads the (B, T, H, D) inputs in place, masks a ragged last
chunk as identity steps, and writes the final state itself.  Its decay
factors are all <= 1 (see the source note), so it stays finite where the
reference's ``k * exp(-cum)`` overflows.

On the H100 the function is bound by bytes, narrowly (its f32 work at the
kernel's chunk takes almost as long at the f32 peak); this first kernel
does its products as f32 FMAs on the CUDA cores, far from either bound.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
RWKV_CHUNK = 128        # chunk of ``rwkv6_chunked_jnp`` (layers.py RWKV_CHUNK)


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
    outs = []
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
        outs.append(o_state + o_intra + o_diag)
    o = torch.cat(outs, dim=1)[:, :T]
    return o, S


def rwkv6_scan(r, k, v, w, u, s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over a whole sequence: r, k, v, w (B,T,H,D) float32, u (H,D)
    float32, optional initial state s0 (B,H,D,D) float32.  Returns (o
    (B,T,H,D), final state (B,H,D,D)), float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)}")
    B, T, H, D = r.shape
    if tuple(u.shape) != (H, D) or (
            s0 is not None and tuple(s0.shape) != (B, H, D, D)):
        raise ValueError(f"u{tuple(u.shape)} / s0"
                         f"{None if s0 is None else tuple(s0.shape)} do not "
                         f"match r{tuple(r.shape)}")
    tensors = [t for t in (r, k, v, w, u, s0) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return rwkv6_scan_plain(r, k, v, w, u, s0)
    if not (r.is_cuda and all(t.device == r.device for t in tensors)):
        raise ValueError("rwkv6_scan: all inputs must lie on one CUDA device "
                         "(or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rwkv6_scan: float32 inputs; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"rwkv6_scan kernel: head_dim in {HEAD_DIMS}; got D={D}")
    if not all(t.is_contiguous() for t in tensors) or not all(
            t.data_ptr() % 16 == 0 for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: inputs must be contiguous, r/k/v/w "
                         "16-byte aligned (the kernel loads 16 bytes at a "
                         "time)")
    o = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return o, state
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), state.data_ptr(), B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return o, state


rwkv6_scan.launches = 0    # kernel launches since the last reset
