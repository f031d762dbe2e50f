"""The program's own spans read into per-layer numbers.

A served run given a ``Tracer`` on a wall clock gets, from
``repro_torch.serving.spans``, one ``run`` tuple a slot executed, one
``wait`` tuple a sleep of the loop's clock and one ``refuse`` tuple a
request queued on arrival, and, while ``torch.profiler`` records, the
``record_function`` ranges ``repro_torch.run.<kind>`` and
``repro_torch.wait.<cause>`` in the trace.  ``bench.run_cell`` gives the
traced run's window a ``Tracer`` and keeps its tuples on ``Run.events``,
its counters on ``Run.meta``, and the ranges in the trace's reduction
(``Run.trace``, ``trace.reduce``).  The readers here take the tuples (or
that reduction) and return a share in %, or None where there is nothing
to read: a run without the program's spans, as from a program that has
none.

  ``slot_wait_share``       seconds the loop slept to modeled slot ends
                            (``wait`` with cause ``slot``) over the window;
  ``queued_arrival_share``  arrivals with a ``refuse`` tuple over arrivals;
  ``decode_host_share``     the engines' host seconds over the seconds
                            executed, summed over decode ``run`` tuples;
  ``idle_in_decode_share``  device idle inside ``repro_torch.run.decode``
                            ranges over the profiled sub-window
                            (``ecobench.window``).
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Optional

DECODE_RANGE = "repro_torch.run.decode"


def _of(events, etype: str) -> list:
    return [e for e in events or () if e[0] == etype]


def slot_wait_share(events, window_s: float) -> Optional[float]:
    waits = _of(events, "wait")
    if not waits or not window_s:
        return None
    return 100.0 * sum(w[2] for w in waits if w[3] == "slot") / window_s


def queued_arrival_share(events) -> Optional[float]:
    arrivals = {e[2] for e in _of(events, "arrive")}
    if not arrivals or not _of(events, "run"):
        return None
    refused = {e[2] for e in _of(events, "refuse")} & arrivals
    return 100.0 * len(refused) / len(arrivals)


def decode_host_share(events) -> Optional[float]:
    runs = [r for r in _of(events, "run")
            if r[3] == "decode" and r[7] is not None]
    ran = sum(r[6] for r in runs)
    if not ran:
        return None
    return 100.0 * sum(r[7] for r in runs) / ran


def idle_in_decode_share(trace: Optional[dict]) -> Optional[float]:
    """Device idle (no kernel, copy or set) inside the decode ranges, over
    the profiled sub-window, from its reduction (``trace.reduce``); each
    range is cut to the sub-window."""
    if not trace or not trace["window_s"]:
        return None
    ranges = trace["ranges"].get(DECODE_RANGE)
    if not ranges:
        return None
    w = trace["window_s"]
    busy = trace["busy"]
    ends = [b1 for _, b1 in busy]
    idle = 0.0
    for r0, r1 in ranges:
        s, t = max(r0, 0.0), min(r1, w)
        if t <= s:
            continue
        idle += t - s
        i = bisect.bisect_right(ends, s)     # the first busy one ending past s
        while i < len(busy) and busy[i][0] < t:
            idle -= min(t, busy[i][1]) - max(s, busy[i][0])
            i += 1
    return 100.0 * idle / w


def refusals(events) -> Dict[str, int]:
    """Refused arrivals by the constraint each instance named, as
    ``"<first>/<second>/..."`` in instance order."""
    out = collections.Counter()
    for e in _of(events, "refuse"):
        out["/".join(str(why) for _, why in e[3])] += 1
    return dict(out)


def decode_over_modeled(events) -> Optional[float]:
    """Seconds executed over seconds modeled, summed over decode slots
    (a ``run`` paired with its ``slot`` span by the modeled end)."""
    modeled = {(e[2], e[1] + e[4]): e[4] for e in _of(events, "slot")
               if e[3] == "decode"}
    pairs = [(r[6], modeled[(r[2], r[5])]) for r in _of(events, "run")
             if r[3] == "decode" and (r[2], r[5]) in modeled]
    den = sum(m for _, m in pairs)
    return sum(x for x, _ in pairs) / den if den else None
