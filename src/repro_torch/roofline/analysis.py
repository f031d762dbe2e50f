"""Roofline terms of a dry run (``repro.roofline.analysis``), for the H100.

    compute term    = FLOPs      / peak_FLOP/s
    memory  term    = HBM bytes  / HBM_bw
    collective term = wire_bytes / link_bw

all per device.  The reference parses post-SPMD HLO; the port counts the
local (per-device) aten ops of the step as they run on meta tensors
(``repro_torch.roofline.op_costs``), and ``collect_collectives`` reads the
c10d collectives recorded there, converting their bytes to on-wire bytes
with the standard ring factors (all-reduce moves ~2x its operand; AG / RS
/ A2A ~1x).

``H100_SXM``: the figures of ``repro_torch.serving.engine`` (989e12 bf16
dense FLOP/s, 3.35e12 B/s of HBM3, 80e9 bytes).  ``link_bw`` is 450e9 B/s,
one direction of one GPU's NVLink 4 (18 links x 25 GB/s).  A 16x16 or
2x16x16 mesh of H100s spans 32 or 64 eight-GPU hosts, so a collective
over the 16-way model axis or any batch axis leaves its host and runs at
the hosts' network rate (one 400 Gb/s NIC a GPU: 50e9 B/s), a ninth of
this figure: the collective term is the NVLink-bound floor, as the
reference's one ICI link rate is for its pods.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# on-wire factor per collective kind (ring algorithms, large-N limit)
_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per device, bf16
    hbm_bw: float              # bytes/s per device
    link_bw: float             # bytes/s per link, one direction
    hbm_bytes: float


H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)


def collect_collectives(ops: List[dict]) -> Tuple[float, List[dict]]:
    """The recorded collectives (``op_costs.OpCosts.collective_ops``: one
    dict per call with its ``kind`` and the ``bytes`` of its result) ->
    (total on-wire bytes per device, per-op detail list)."""
    out, total = [], 0.0
    for op in ops:
        wire = op["bytes"] * _WIRE_FACTOR[op["kind"]]
        total += wire
        out.append({**op, "trips": 1, "wire_bytes": wire})
    return total, out


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    hw: HardwareSpec = H100_SXM,
) -> Dict[str, float]:
    """All inputs are PER-DEVICE quantities of the SPMD program, so the
    per-device denominators apply directly."""
    compute_s = flops_per_device / hw.peak_flops
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = wire_bytes_per_device / hw.link_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }
