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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
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
    version; CUDA tensors launch the kernel or raise (on an input that
    requires grad while grad is enabled, too: the kernel has no
    backward)."""
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
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("rwkv6_scan: inputs must be contiguous and 16-byte "
                         "aligned (the kernel moves 16 bytes at a time)")
    _build.refuse_grad("rwkv6_scan", *tensors)
    o = torch.empty_like(r)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return o, state
    # per chunk: its state delta, then the state entering it (D*D), and its
    # decay (D)
    n = -(-T // KERNEL_CHUNK)
    scratch = torch.empty(B * H * n * (D * D + D), dtype=torch.float32,
                          device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), state.data_ptr(), scratch.data_ptr(), B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return o, state


rwkv6_scan.launches = 0    # calls (3 grid launches each) since the last reset
