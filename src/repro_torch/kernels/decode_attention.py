"""Decode attention: the Hopper kernel, its plain version, its count.

Replaces the TPU kernel ``decode_attention``
(``repro/kernels/decode_attention.py``, ``_decode_kernel``), which the JAX
model reaches as ``decode_attention_jnp``.  The CUDA source is
``csrc/decode_attention.cu``: one thread block per (kv head, batch) serves
the G grouped query heads together and loops over the cache in key tiles
up to ``lengths[b]``, so each valid cache row is read exactly once.

On the H100 the function is bound by bytes (the valid K/V); the (Hkv, B)
grid fills under half the SMs, which a later split-S pass addresses.

A sequence with length 0 returns zeros, as ``repro.kernels.ref`` does for
an empty prefill row; the serving engine never asks for one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import rounded_softmax_pv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16            # query heads per kv head served by one block


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """q: (B,Hq,D); caches: (B,S,Hkv,D); lengths: (B,) valid entries.
    Naive masked softmax in f32 (the style of
    ``repro.kernels.ref.decode_attention_ref``), with p rounded to the
    cache dtype before P.V as the Pallas body and the kernel do."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                     k_cache.float()) * (D ** -0.5)
    mask = torch.arange(S, device=q.device)[None] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    # one score row per head: (B,Hkv,G,1,S) -> (B,Hkv,G,1,D)
    o = rounded_softmax_pv(s[..., None, :], v_cache, "bhgqs,bshd->bhgqd")
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths):
    """One new token per sequence: q (B,Hq,D) over caches (B,S,Hkv,D)
    masked at ``lengths`` (B,) int32; returns (B,Hq,D) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != D or Hkv == 0
            or Hq % Hkv or tuple(lengths.shape) != (B,)):
        raise ValueError(f"q{tuple(q.shape)}, cache{tuple(k_cache.shape)}, "
                         f"lengths{tuple(lengths.shape)} do not match")
    tensors = (q, k_cache, v_cache, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("decode_attention: all inputs must lie on one CUDA "
                         "device (or all on the CPU)")
    if (q.dtype not in _DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype or lengths.dtype != torch.int32):
        raise TypeError(f"decode_attention: float32 or bfloat16 q/caches of "
                        f"one dtype and int32 lengths; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}, {lengths.dtype}")
    if D not in HEAD_DIMS or Hq // Hkv > MAX_GROUP:
        raise NotImplementedError(
            f"decode_attention kernel: head_dim in {HEAD_DIMS} and "
            f"Hq/Hkv <= {MAX_GROUP}; got D={D}, G={Hq // Hkv}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k_cache, v_cache)) \
            or not lengths.is_contiguous():
        raise ValueError("decode_attention: inputs must be contiguous, q "
                         "and the caches 16-byte aligned (the kernel loads "
                         "16 bytes at a time)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D,
            D ** -0.5, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0    # kernel launches since the last reset
