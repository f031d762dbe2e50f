"""Trace audit summary: is a converted trace what you think it is?

``trace_stats`` reports the numbers that decide whether a trace exercises
the autoscaling claims — burstiness (CV of inter-arrival gaps; ~1 for
Poisson, >1 bursty), mean rate, and the length percentiles that size the
KV/prefill load — so a conversion or transform that silently mangled the
trace is visible before it burns a sweep.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.traces.convert import TraceDict


def trace_stats(records: List[TraceDict]) -> Dict[str, float]:
    out: Dict[str, float] = {"n_requests": float(len(records))}
    if not records:
        return out
    times = np.asarray([r["arrival_time"] for r in records], dtype=float)
    prompts = np.asarray([r["prompt_len"] for r in records], dtype=float)
    outs = np.asarray([r["output_len"] for r in records], dtype=float)
    span = float(times[-1] - times[0])
    out["span_s"] = span
    out["mean_rate"] = (len(records) - 1) / span if span > 0 else 0.0
    if len(times) >= 3:
        gaps = np.diff(times)
        mean_gap = gaps.mean()
        out["burstiness_cv"] = (float(gaps.std() / mean_gap)
                                if mean_gap > 0 else 0.0)
    for name, arr in (("prompt", prompts), ("output", outs)):
        out[f"{name}_mean"] = float(arr.mean())
        out[f"{name}_p50"] = float(np.percentile(arr, 50))
        out[f"{name}_p99"] = float(np.percentile(arr, 99))
    classes = sorted({str(r.get("slo_class", "")) for r in records
                      if r.get("slo_class")})
    if classes:
        out["slo_classes"] = ",".join(classes)   # type: ignore[assignment]
    return out


def format_stats(stats: Dict[str, float]) -> str:
    keys = ("n_requests", "span_s", "mean_rate", "burstiness_cv",
            "prompt_mean", "prompt_p50", "prompt_p99",
            "output_mean", "output_p50", "output_p99", "slo_classes")
    lines = []
    for k in keys:
        if k in stats:
            v = stats[k]
            sval = f"{v:.3f}" if isinstance(v, float) else str(v)
            lines.append(f"  {k:>14}: {sval}")
    return "\n".join(lines)
