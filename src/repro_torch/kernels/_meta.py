"""The kernels' shape-only path, for tensors on the ``meta`` device.

The dry run (``repro_torch.launch.dryrun_lib``) runs the model on meta
tensors, where no kernel can launch.  Each wrapper asks for this path
explicitly, by its inputs' device: it returns outputs of the right shape
and dtype and reports the kernel's work, its operations and the bytes it
must move, to the active counters (``repro_torch.roofline.op_costs``).
Where autograd records the call, the backward reports the backward
kernel's work and returns gradients of the inputs' shapes.  CPU tensors
still take the plain versions and CUDA tensors still launch the kernels.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

SINKS: List[Callable[[str, float, float], None]] = []


def is_meta(*tensors) -> bool:
    return any(t is not None and t.device.type == "meta" for t in tensors)


def report(name: str, ops: float, nbytes: float) -> None:
    for sink in SINKS:
        sink(name, float(ops), float(nbytes))


def attention_pairs(T: int, S: int, causal: bool, window: int,
                    q_offset: int) -> int:
    """(query, key) pairs the masks leave open, per head (query position
    ``q_offset + i`` over keys 0 .. S - 1)."""
    p = q_offset + np.arange(T, dtype=np.int64)
    hi = np.minimum(S - 1, p) if causal else np.full(T, S - 1)
    lo = np.maximum(0, p - window + 1) if window else np.zeros(T, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _empty(specs):
    return tuple(torch.empty(s, dtype=d, device="meta") for s, d in specs)


class _MetaFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, outputs, fwd_work, bwd_work, *inputs):
        report(name, *fwd_work)
        ctx.name, ctx.bwd_work = name + "_bwd", bwd_work
        ctx.specs = [None if t is None else (t.shape, t.dtype)
                     for t in inputs]
        return _empty(outputs)

    @staticmethod
    def backward(ctx, *grads):
        report(ctx.name, *ctx.bwd_work)
        return (None, None, None, None) + tuple(
            None if s is None else torch.empty(s[0], dtype=s[1],
                                               device="meta")
            for s in ctx.specs)


def run(name: str, inputs: Sequence[Optional[torch.Tensor]],
        outputs: Sequence[Tuple[tuple, torch.dtype]],
        fwd_work: Tuple[float, float],
        bwd_work: Optional[Tuple[float, float]] = None) -> tuple:
    """The shape-only call of kernel ``name``: ``outputs`` as (shape,
    dtype) pairs, ``fwd_work`` / ``bwd_work`` as (operations, bytes)."""
    if bwd_work is not None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _MetaFn.apply(name, list(outputs), fwd_work, bwd_work,
                             *inputs)
    report(name, *fwd_work)
    return _empty(outputs)
