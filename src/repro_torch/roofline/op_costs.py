"""Per-device costs of a step from its local aten ops: the port's
counterpart of ``repro.roofline.hlo_costs``.

The reference re-derives FLOPs, HBM bytes and collective bytes from
post-SPMD HLO text.  The port has no HLO: ``OpCosts`` is a
``TorchDispatchMode`` that sees the ops each device runs on its own
shards.  DTensor ops are passed on to DTensor (the mode returns
NotImplemented for them), which runs them on the local tensors, and those
local ops come back through the mode; the ops DTensor runs on fake
tensors to propagate shapes are skipped.  So every count is per device.

  * FLOPs: 2 * M * N * K for each ``mm``, ``bmm``, ``addmm`` or
    ``baddbmm``, plus each hand-written kernel's own formula, which the
    kernels' meta path reports (``repro_torch.kernels._meta``).
  * HBM bytes: each op reads its operands and writes its output once;
    views, reshapes, factories and the other kinds of ``_SKIP_MEM_OPS``
    move nothing; the kernels report their own bytes.
  * Collective wire bytes: the bytes of each c10d collective's result,
    times the ring factors (``repro_torch.roofline.analysis``).
  * Peak live bytes: the bytes of the tensors alive before the step (its
    arguments) plus the most that the op outputs made inside it held at
    once, each storage counted once and freed when its last tensor dies.

Only the bytes of tensors count, so it runs on meta tensors (nothing is
allocated) as well as on real ones.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _meta

_FLOP_OPS = {"mm", "bmm", "addmm", "baddbmm"}
_SKIP_MEM_OPS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "select", "slice", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "diagonal", "view_as_real", "view_as_complex", "_reshape_alias",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "set_", "_local_scalar_dense",
    "wait_tensor", "sym_size", "sym_stride", "sym_numel", "is_same_size",
}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except Exception:       # noqa: BLE001 — tensors without a storage
        return None


def _storage_bytes(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().nbytes()
    except Exception:       # noqa: BLE001
        return _nbytes(t)


_UPDATE_OPS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
               "scatter_", "scatter_add", "scatter_add_", "index_copy",
               "index_copy_", "index_add", "index_add_", "slice_scatter",
               "select_scatter", "copy_"}
_GATHER_OPS = {"index", "gather", "index_select", "embedding"}


def _op_bytes(name: str, ins, outs) -> float:
    """HBM traffic of one op, as ``hlo_costs._line_bytes`` estimates it:
    an update of a slice of a buffer in place (scatter, index_put, a
    copy into a view) moves 2 x its small operands, not the buffer; a
    gather moves 2 x its output; anything else its operands and output."""
    out = sum(_nbytes(t) for t in outs)
    if name in _UPDATE_OPS and name != "copy_":
        return 2.0 * sum(_nbytes(t) for t in ins if _nbytes(t) < out)
    if name in _GATHER_OPS:
        return 2.0 * out
    return float(sum(_nbytes(t) for t in ins) + out)


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_ops: List[dict] = dataclasses.field(default_factory=list)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    ops: int = 0
    peak_live_bytes: float = 0.0


class OpCosts(TorchDispatchMode):
    """``with OpCosts() as oc: step(...)``, then ``oc.costs``.  Pass the
    step's arguments as ``live`` to count them in the peak."""

    def __init__(self, live=()):
        super().__init__()
        self.costs = Costs()
        self._live: Dict[object, int] = {}      # storage -> bytes
        self._refs: Dict[object, int] = {}      # storage -> live tensors
        self._base = 0
        self._base_keys = set()
        for t in _tensors(live):
            local = t.to_local() if hasattr(t, "to_local") else t
            key = _storage_key(local)
            if key not in self._base_keys:
                self._base_keys.add(key)
                self._base += _storage_bytes(local)
        self._now = 0
        self.costs.peak_live_bytes = self._base

    # -- kernels (their meta path) ---------------------------------------
    def _kernel(self, name: str, ops: float, nbytes: float) -> None:
        self.costs.flops += ops
        self.costs.hbm_bytes += nbytes
        k = self.costs.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += ops
        k["bytes"] += nbytes

    def __enter__(self):
        _meta.SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _meta.SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- live bytes --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None or key in self._base_keys:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._live[key] = _storage_bytes(t)
            self._now += self._live[key]
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                             self._base + self._now)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        n = self._refs.get(key)
        if n is None:
            return
        if n <= 1:
            del self._refs[key]
            self._now -= self._live.pop(key)
        else:
            self._refs[key] = n - 1

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors(args) + _tensors(kwargs)
        if any(isinstance(t, FakeTensor) for t in ins):
            return func(*args, **kwargs)      # DTensor's shape propagation
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                        # its fake arguments
        c = self.costs
        c.ops += 1
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if name in _FLOP_OPS:
            a, b = args[-2], args[-1]
            if name in ("mm", "addmm"):
                c.flops += 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
            else:
                c.flops += (2.0 * a.shape[0] * a.shape[1] * a.shape[2]
                            * b.shape[2])
        if ns in ("_c10d_functional", "c10d", "c10d_functional") \
                and name in _COLLECTIVES:
            nbytes = sum(_nbytes(t) for t in outs)
            c.collective_ops.append({"kind": _COLLECTIVES[name],
                                     "bytes": float(nbytes),
                                     "op": f"{ns}.{name}"})
        elif name not in _SKIP_MEM_OPS:
            c.hbm_bytes += _op_bytes(name, ins, outs)
        for t in outs:
            self._track(t)
        return out
