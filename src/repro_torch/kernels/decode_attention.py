"""Decode attention: the Hopper kernel, its plain versions, its count.

Replaces the TPU kernel ``decode_attention``
(``repro/kernels/decode_attention.py``, ``_decode_kernel``), which the JAX
model reaches as ``decode_attention_jnp``.  The CUDA source is
``csrc/decode_attention.cu``, split over the cache's rows
(flash-decoding) in two grid launches per call:

1. one block per (split, kv head, batch) reads ``split_rows`` cache rows
   (cp.async into a 2-stage ring) for the G grouped query heads together,
   so each valid row is read once, and writes f32 partials (m, l, acc)
   into scratch that the wrapper allocates; a split wholly past
   ``lengths[b]`` exits at once;
2. one pass combines the splits in split order, so results are
   identical run to run.

The function is bound by bytes (the valid K/V); the split count gives the
132 SMs enough blocks, and loads in flight, where one block per (kv head,
batch) gave 64 (llama3-8b) or 8 (recurrentgemma-2b).  The split count
depends on the shapes and the SM count only (``split_rows``), never on
``lengths``, which live on the device: the call needs no host sync and
keeps fixed shapes for a CUDA graph of the decode step.
``decode_attention.launches`` counts calls (one per attention layer per
step), each of them two grid launches.

bf16 does its products on the tensor cores (on the CUDA cores the G
products per cached element, not the bytes, set the time); f32 keeps
IEEE FMAs.  ptxas (sm_90a): bf16 64 / 124 / 167 registers at D 64 / 128 /
256 and 39 / 74 / 144 KB of shared memory, f32 40-90 registers, the
combine 32; no spills (the table in the CUDA source).

A sequence with length 0 returns zeros, as ``repro.kernels.ref`` does for
an empty prefill row; the serving engine never asks for one.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.flash_prefill import rounded_softmax_pv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16            # query heads per kv head served by one block
SPLIT_QUANTUM = 128       # split_rows is a multiple of this: two 64-row tiles


def split_rows(B: int, Hkv: int, S: int, sm_count: int) -> int:
    """Cache rows that one block of the kernel's first pass reads.

    A function of the shapes and the SM count only, never of the lengths:
    it asks for 4 blocks per SM over the full S (so 2 when half the rows
    are valid), in slices of a whole number of ``SPLIT_QUANTUM`` rows, so
    that every block's 2-stage ring holds two 64-row tiles.  At
    recurrentgemma-2b's decode (B 8, Hkv 1, S 2048, 132 SMs) that is 128
    rows, 16 splits; at llama3-8b's (B 8, Hkv 8, S 2048) 256 rows, 8
    splits."""
    want = -(-4 * sm_count // max(1, B * Hkv))        # splits per sequence
    rows = -(-max(S, 1) // want)
    return -(-rows // SPLIT_QUANTUM) * SPLIT_QUANTUM


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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


def decode_attention_split_plain(q, k_cache, v_cache, lengths, rows: int):
    """The kernel's two passes in plain PyTorch (f32): the cache cut into
    ``rows``-row splits; per split and head m_i (max score over its valid
    keys), l_i (sum of the unrounded p = exp(s - m_i)) and acc_i (p rounded
    to the cache dtype, times V); then, in split order,
    o = sum exp(m_i - m) acc_i / sum exp(m_i - m) l_i.  A split with no valid
    key adds nothing; a sequence with none gives zeros.  For tests and
    ``chip_smoke.py``: it is the kernel's algorithm, not a faster path."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    valid = (torch.arange(S, device=q.device)[None]
             < lengths.to(q.device)[:, None])
    m = torch.full((B, Hkv, G), float("-inf"), device=q.device)
    parts = []
    for r0 in range(0, S, rows):
        k = k_cache[:, r0:r0 + rows].float()
        v = v_cache[:, r0:r0 + rows]
        s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (D ** -0.5)
        s = s.masked_fill(~valid[:, None, None, r0:r0 + rows], float("-inf"))
        m_i = s.amax(-1)
        m_safe = torch.where(torch.isfinite(m_i), m_i, 0.0)
        p = torch.exp(s - m_safe[..., None])
        acc_i = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(),
                             v.float())
        parts.append((m_i, p.sum(-1), acc_i))
        m = torch.maximum(m, m_i)
    num = torch.zeros((B, Hkv, G, D), device=q.device)
    den = torch.zeros((B, Hkv, G), device=q.device)
    for m_i, l_i, acc_i in parts:                       # in split order
        w = torch.where(torch.isfinite(m_i),
                        torch.exp(m_i - torch.where(torch.isfinite(m), m, 0.)),
                        0.0)
        num = num + w[..., None] * acc_i
        den = den + w * l_i
    o = num / torch.where(den > 0, den, 1.0)[..., None]   # den = 0: o is 0
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths):
    """One new token per sequence: q (B,Hq,D) over caches (B,S,Hkv,D)
    masked at ``lengths`` (B,) int32; returns (B,Hq,D) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise (on an input that requires grad while grad is enabled, too: the
    kernel has no backward)."""
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
    if _meta.is_meta(*tensors):
        # every cache row, as the reference's lowering counts them
        es = q.element_size()
        return _meta.run("decode_attention", tensors, [(q.shape, q.dtype)],
                         (4 * Hq * D * B * S,
                          es * (2 * B * Hq * D + 2 * B * S * Hkv * D)
                          + 4 * B))[0]
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
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if B == 0:
        return torch.empty_like(q)
    out = run_kernel(q, k_cache, v_cache, lengths,
                     split_rows(B, Hkv, S, _sm_count(q.device.index)))
    decode_attention.launches += 1
    return out


def run_kernel(q, k_cache, v_cache, lengths, rows: int):
    """The kernel's two passes at ``rows`` cache rows per split, on inputs
    that ``decode_attention`` has checked; returns (B,Hq,D).  Counts
    nothing (``decode_attention`` counts its calls); ``profile_port.py``
    sweeps ``rows`` through it."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    n_split = -(-S // rows)
    out = torch.empty_like(q)
    # the first pass's partials: acc (B*Hq, n_split, D), then m and l
    scratch = torch.empty(B * Hq * n_split * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, S, Hq,
            Hkv, D, rows, D ** -0.5, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    return out


decode_attention.launches = 0    # calls (2 grid launches each) since reset
