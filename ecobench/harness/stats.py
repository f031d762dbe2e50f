"""Arithmetic over one run's record, shared by the metric readers in
``ecobench/metrics/``.  A record (``bench.Run``) holds each request of the
window on the loop's timeline, the engines' step times, the clock's
sleeps, the model's family (its work counts) and, in the traced run, the
kernel files' calls, the trace's reduction and the program's own spans
and counters."""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

from ecobench.harness import work


def nearest_rank(values: Sequence[float], p: float) -> Optional[float]:
    """The p-th percentile by nearest rank (an infinite value stays one)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def ttfts(run) -> List[float]:
    """TTFT from the due time of every request of the window: to its first
    token where it has one; where it has none at the close, to the close
    (a lower bound on what it will read), or infinite once it has waited
    past the TTFT limit."""
    out = []
    for r in run.requests:
        if r["first"] is not None:
            out.append(r["first"] - r["arrival"])
        else:
            waited = run.close - r["arrival"]
            out.append(math.inf if waited > run.slo["ttft_s"] else waited)
    return out


def tpot(r: dict) -> Optional[float]:
    """``Request.avg_tpot``'s gap, to the latest token for a request not
    finished at the close."""
    n = r["tokens_generated"]
    end = r["finish"] if r["finish"] is not None else r["last_token"]
    if end is None:
        return None
    if n > 2 and r["second"] is not None:
        return (end - r["second"]) / (n - 2)
    if n > 1 and r["first"] is not None:
        return (end - r["first"]) / (n - 1)
    return None


def tpots(run) -> List[float]:
    return [t for t in (tpot(r) for r in run.requests) if t is not None]


def queue_waits(run) -> List[float]:
    """Admission minus due time; the close minus due time for a request
    still in the queue."""
    return [(r["admitted"] if r["admitted"] is not None else run.close)
            - r["arrival"] for r in run.requests]


def output_tokens(run) -> int:
    return sum(len(r["generated"]) for r in run.requests)


def prefill_flops(run) -> float:
    f = run.family.prefill_flops
    return sum(f(run.model, T) for T, _ in run.prefills)


def decode_flops(run) -> float:
    f = run.family.decode_flops
    return sum(f(run.model, b, c) for b, c, _ in run.decodes)


def share_of_peak(run, flops: float, seconds: float) -> Optional[float]:
    """Model FLOPs over ``seconds`` at the chip's peak for the run's dtype."""
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * work.PEAK_FLOPS[run.dtype])


def mean_decode_ms(run) -> Optional[float]:
    if not run.decodes:
        return None
    return 1e3 * sum(dt for _, _, dt in run.decodes) / len(run.decodes)


def idle_share(run) -> Optional[float]:
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline(run, name: str) -> Optional[float]:
    from ecobench.harness.trace import roofline
    t = run.trace
    if not t:
        return None
    return roofline(run.calls.get(name, []), t["kernel_s"].get(name))
