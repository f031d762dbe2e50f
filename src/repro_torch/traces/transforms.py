"""Composable transforms over converted trace records.

Real traces never arrive at the rate or horizon an experiment wants:
Azure's production stream runs minutes between requests, BurstGPT spans
months.  These transforms adapt a converted record list to a simulation
cell while keeping it auditable (``repro_torch.traces.stats.trace_stats``
before/after):

* ``rescale_time`` — multiply every arrival time (compress a day into a
  two-minute diurnal, the paper-style time compression);
* ``normalize_rate`` — rescale so the time-averaged rate hits a target
  req/s exactly (burstiness *shape* is preserved: a pure time dilation);
* ``clip_horizon`` — drop arrivals at/after a horizon;
* ``downsample`` — keep a fraction of rows, chosen by a seeded
  ``default_rng`` (deterministic: same seed, same excerpt), preserving
  arrival order.

All pure: input lists are never mutated, so transforms chain freely.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.traces.convert import TraceDict


def _copy_with_time(rec: TraceDict, t: float) -> TraceDict:
    out = dict(rec)
    out["arrival_time"] = float(t)
    return out


def span(records: List[TraceDict]) -> float:
    """Arrival span in seconds (first record is at 0 by construction)."""
    if not records:
        return 0.0
    return float(records[-1]["arrival_time"] - records[0]["arrival_time"])


def rescale_time(records: List[TraceDict],
                 factor: float) -> List[TraceDict]:
    """Multiply arrival times by ``factor`` (< 1 compresses)."""
    if factor <= 0:
        raise ValueError(f"time-rescale factor must be > 0, got {factor}")
    return [_copy_with_time(r, r["arrival_time"] * factor)
            for r in records]


def normalize_rate(records: List[TraceDict],
                   target_rate: float) -> List[TraceDict]:
    """Dilate time so the mean rate over the span is ``target_rate``
    req/s.  Needs >= 2 records (a 0/1-request trace has no rate)."""
    if target_rate <= 0:
        raise ValueError(f"target rate must be > 0, got {target_rate}")
    if len(records) < 2:
        return [dict(r) for r in records]
    current = (len(records) - 1) / span(records)
    return rescale_time(records, current / target_rate)


def clip_horizon(records: List[TraceDict],
                 horizon: float) -> List[TraceDict]:
    """Keep arrivals strictly before ``horizon`` seconds."""
    return [dict(r) for r in records if r["arrival_time"] < horizon]


def downsample(records: List[TraceDict], keep_fraction: float,
               seed: int = 0) -> List[TraceDict]:
    """Seeded uniform subsample, arrival order preserved."""
    if not 0.0 < keep_fraction <= 1.0:
        raise ValueError(
            f"keep_fraction must be in (0, 1], got {keep_fraction}")
    if keep_fraction == 1.0 or not records:
        return [dict(r) for r in records]
    rng = np.random.default_rng(seed)
    n_keep = max(1, int(round(keep_fraction * len(records))))
    idx = np.sort(rng.choice(len(records), size=n_keep, replace=False))
    return [dict(records[i]) for i in idx]
