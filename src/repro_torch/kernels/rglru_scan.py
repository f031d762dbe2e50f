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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

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


def rglru_scan(log_a, b, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All h of h_t = exp(log_a_t) * h_{t-1} + b_t: log_a, b (B,T,d)
    float32, optional h0 (B,d) float32 (zeros when None); returns (B,T,d)
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise (on an input that requires grad while grad is enabled,
    too: the kernel has no backward)."""
    if log_a.ndim != 3 or log_a.shape != b.shape:
        raise ValueError(f"bad shapes log_a{tuple(log_a.shape)} "
                         f"b{tuple(b.shape)}")
    B, T, d = log_a.shape
    if h0 is not None and tuple(h0.shape) != (B, d):
        raise ValueError(f"h0{tuple(h0.shape)} does not match "
                         f"log_a{tuple(log_a.shape)}")
    tensors = [t for t in (log_a, b, h0) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return rglru_scan_plain(log_a, b, h0)
    if not (log_a.is_cuda and all(t.device == log_a.device
                                  for t in tensors)):
        raise ValueError("rglru_scan: all inputs must lie on one CUDA device "
                         "(or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rglru_scan: float32 inputs; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan: inputs must be contiguous")
    _build.refuse_grad("rglru_scan", *tensors)
    if log_a.numel() == 0:
        return torch.empty_like(log_a)
    out = run_kernel(log_a, b, h0, time_chunk(T))
    rglru_scan.launches += 1
    return out


def run_kernel(log_a, b, h0, chunk: int) -> torch.Tensor:
    """The kernel's two passes at ``chunk`` steps per time chunk, on inputs
    that ``rglru_scan`` has checked; returns (B,T,d).  Counts nothing
    (``rglru_scan`` counts its calls); ``profile_port.py`` sweeps
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
