"""Flash-attention prefill: the Hopper kernel, its plain version, its count.

Replaces the TPU kernel ``flash_prefill`` (``repro/kernels/flash_prefill.py``,
``_flash_kernel``), which the JAX model reaches as ``blockwise_attention``.
The CUDA source is ``csrc/flash_prefill.cu``: one thread block per (q tile,
kv head, batch) holding the G query heads of its kv head, so K/V are never
repeated; the TPU grid's sequential kv axis is a loop over key tiles inside
the block; causal, window, ``q_offset`` and ``k_pos < S`` masks are applied
in the kernel, so ragged T and S need no padded copies.

On the H100 the function is bound by operations (see the note in the CUDA
source).  bf16, the dtype of every served path, runs QK^T and P.V on the
tensor cores with ``wgmma`` (one warpgroup per 64-row tile, Q, K and V
bf16 in shared memory in wgmma's swizzled layout, P from registers, f32
sums) with 64-key K/V tiles copied asynchronously into a 2-stage ring,
heaviest causal q tiles first.  f32 keeps IEEE f32 FMAs on the CUDA
cores (no TF32), for the models' f32 parity runs.  ptxas (sm_90a): bf16
117 / 150 / 213 registers at D 64 / 128 / 256, no spills, 41 / 81 / 161 KB
of shared memory (2 blocks per SM at D 128, 1 at D 256); f32 92-128
registers, 88 B of spills at D 256 (the table in the CUDA source).

A row with no valid key returns zeros, as ``repro.kernels.ref`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64            # query heads per kv head in one tile


def rounded_softmax_pv(s, v, pv: str):
    """Softmax of the f32 scores ``s`` (-inf where masked) times ``v``,
    with the kernels' rounding: p = exp(s - row max) is rounded to v's
    dtype before P.V, while the row sum l adds the unrounded p.  A row
    with no valid key gives zeros.  ``pv`` is the einsum of P.V, whose
    output keeps the score's row as its second-to-last axis."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum(pv, p.to(v.dtype).float(), v.float())
    return o / torch.where(l > 0, l, 1.0)       # l = 0: o is 0 already


def flash_prefill_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B,T,Hq,D); k,v: (B,S,Hkv,D).  Naive masked softmax attention
    in f32 (the style of ``repro.kernels.ref.flash_prefill_ref``), with p
    rounded to v's dtype before P.V as the Pallas body and the kernel do."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float()) * (D ** -0.5)
    q_pos = q_offset + torch.arange(T, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    # (B,Hkv,G,T,D) -> (B,T,Hkv,G,D)
    o = rounded_softmax_pv(s, v, "bhgqs,bshd->bhgqd").permute(0, 3, 1, 2, 4)
    return o.reshape(B, T, Hq, D).to(q.dtype)


def flash_prefill(q, k, v, *, causal=True, window=0, q_offset=0):
    """GQA attention of q (B,T,Hq,D) over k, v (B,S,Hkv,D); returns
    (B,T,Hq,D) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q{tuple(q.shape)} does not group over "
                         f"k{tuple(k.shape)}")
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_prefill: q, k, v must lie on one CUDA device "
                         "(or all on the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill: float32 or bfloat16, one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS or Hq // Hkv > MAX_GROUP:
        raise NotImplementedError(
            f"flash_prefill kernel: head_dim in {HEAD_DIMS} and "
            f"Hq/Hkv <= {MAX_GROUP}; got D={D}, G={Hq // Hkv}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_prefill: q, k, v must be contiguous and "
                         "16-byte aligned (the kernel loads 16 bytes at a "
                         "time)")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, Hq, Hkv, D, int(bool(causal)), int(window),
            int(q_offset), D ** -0.5, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0    # kernel launches since the last reset
