"""RG-LRU scan: the Hopper kernel, its plain version, its count.

Replaces the TPU kernel ``rglru_scan`` (``repro/kernels/rglru_scan.py``,
``_rglru_kernel``); the JAX model computes the same function as
``rglru_scan_jnp``.  Elementwise over channels, with an optional initial
state h0::

    h_t = exp(log_a_t) * h_{t-1} + b_t

The CUDA source is ``csrc/rglru_scan.cu``: one thread per (channel, batch
row), neighbouring channels on neighbouring lanes, walks the time axis in
chunks of 16 steps whose inputs it loads ahead of the dependent updates;
steps past T are identity steps and channels past d have no thread.

On the H100 the function is bound by bytes (log_a and b read once, h
written once); this first kernel has only B*d threads walking T dependent
steps, far from that bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


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
    kernel or raise."""
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
    out = torch.empty_like(log_a)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(log_a.device):
        err = lib.rglru_scan_launch(
            log_a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(), B, T, d,
            torch.cuda.current_stream(log_a.device).cuda_stream)
    _build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0    # kernel launches since the last reset
