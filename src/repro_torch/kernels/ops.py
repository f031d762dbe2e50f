"""Dispatch names for the kernels, as ``repro.kernels.ops`` names them.
Each wrapper launches its Hopper kernel for CUDA tensors and runs its
plain version for CPU tensors; the model calls these names."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

flash_prefill_op = flash_prefill
decode_attention_op = decode_attention
rglru_scan_op = rglru_scan
rwkv6_scan_op = rwkv6_scan
