"""Flight-recorder analysis: per-instance time series, per-request TTFT
attribution, TPOT jitter, and the decode-interference score.

Everything here consumes the raw event tuples (``repro_torch.obs.events``,
field names in ``repro_torch.obs.export.SCHEMA``) — the analyses run equally
on a live ``Tracer.events`` list or on events re-read from a JSONL
trace, and on sim or served (replay) runs, because both paths emit the
same bus.

TTFT attribution contract
-------------------------
For a request prefilled in a whole ``prefill`` slot (the PaDG default;
chunked-hybrid prefills are counted as ``unattributed``):

    ttft = queue_wait + prefill_wait + prefill_service + transfer

with ``queue_wait = t_admit - t_arrive`` (arrival to the *last*
admission: direct admit or queue drain), ``prefill_wait =
t_slot - t_admit`` (admitted but waiting for the prefill batch to
start), ``prefill_service = dur`` (the slot span; the sim stamps the
first token at slot end), and ``transfer = 0.0`` in simulation (FuDG KV
handoff happens *after* the first-token stamp; real-path transfers
would land here).  The decomposition telescopes, so the components sum
to the measured TTFT *exactly* — bit-equal, not approximately — which
``tests/golden/trace_attribution.json`` pins.

Interference score
------------------
The paper's Fig. 2 observation: co-locating prefill with decode
stretches decode steps.  Per instance we walk the slot chain in time
order; for each decode/hybrid slot that extends a *contiguous* chain
(no idle gap) after a previous decode, the stretch is
``(t_end - prev_decode_end) / dur`` — 1.0 when decode steps run
back-to-back, > 1.0 when prefill slots were interleaved between them.
The score is the mean stretch minus 1.0 (0.0 = perfect isolation).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.events import slot_rids

_EPS = 1e-9
_DECODE_KINDS = ("decode", "hybrid")


def _events_of(tracer_or_events) -> List[tuple]:
    return list(getattr(tracer_or_events, "events", tracer_or_events))


def _percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile without numpy (keeps this module
    import-light for the CLI)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
    return float(s[k])


# --------------------------------------------------------------------- #
# per-instance time series
# --------------------------------------------------------------------- #
def instance_series(tracer_or_events) -> Dict[int, Dict[str, list]]:
    """Per-instance time series sampled at slot boundaries: parallel
    lists keyed ``t, kind, dur, batch, kv_occupancy, queue_depth,
    decode_batch_util, prefill_backlog_tokens``."""
    out: Dict[int, Dict[str, list]] = {}
    for ev in _events_of(tracer_or_events):
        if ev[0] != "slot":
            continue
        (_, t, iid, kind, dur, rids, kv_used, kv_cap, n_pending,
         pending_tokens, n_decoding, queue_len, max_batch) = ev
        s = out.setdefault(iid, defaultdict(list))
        s["t"].append(t)
        s["kind"].append(kind)
        s["dur"].append(dur)
        s["batch"].append(len(rids))
        s["kv_occupancy"].append(kv_used / kv_cap if kv_cap else 0.0)
        s["queue_depth"].append(queue_len)
        s["decode_batch_util"].append(
            n_decoding / max_batch if max_batch else 0.0)
        s["prefill_backlog_tokens"].append(pending_tokens)
    return {iid: dict(s) for iid, s in out.items()}


# --------------------------------------------------------------------- #
# TTFT attribution + TPOT jitter
# --------------------------------------------------------------------- #
def attribution(tracer_or_events) -> Dict[str, object]:
    """Per-request TTFT attribution rows + aggregate digest.

    Returns ``{"rows": [...], "unattributed": int, "totals": {...}}``;
    each row carries ``rid, arrival, admit, slot_start, queue_wait,
    prefill_wait, prefill_service, transfer, ttft`` with the exactness
    invariant ``queue_wait + prefill_wait + prefill_service + transfer
    == ttft`` (see the module docstring).  Requests prefilled via
    chunked-hybrid slots or with an incomplete lifecycle count as
    ``unattributed``."""
    events = _events_of(tracer_or_events)
    arrive: Dict[int, float] = {}
    admits: Dict[int, List[float]] = defaultdict(list)
    last_prefill: Dict[int, Tuple[float, float]] = {}  # rid -> (t, dur)

    for ev in events:
        etype = ev[0]
        if etype == "arrive":
            arrive[ev[2]] = ev[1]
        elif etype in ("admit", "drain"):
            admits[ev[2]].append(ev[1])
        elif etype == "slot":
            _, t, _iid, kind, dur, rids = ev[:6]
            if kind == "prefill":
                for rid in slot_rids(rids):
                    last_prefill[rid] = (t, dur)
            # NB: a hybrid slot's rids are its decode batch; the chunked
            # prefills riding it never appear in a whole prefill slot
            # and therefore count as unattributed
        elif etype == "requeue":
            # resubmitted after a fault: earlier prefill evidence is
            # stale, the post-requeue lifecycle decides
            last_prefill.pop(ev[2], None)

    rows = []
    unattributed = 0
    for rid, t_arr in sorted(arrive.items()):
        hit = last_prefill.get(rid)
        if hit is None:
            # never whole-slot prefilled (still queued at horizon, or
            # chunked-hybrid prefill)
            unattributed += 1
            continue
        t_slot, dur = hit
        adm = [a for a in admits.get(rid, ()) if a <= t_slot + _EPS]
        if not adm:
            unattributed += 1
            continue
        t_adm = adm[-1]
        queue_wait = t_adm - t_arr
        prefill_wait = t_slot - t_adm
        transfer = 0.0
        ttft = queue_wait + prefill_wait + dur + transfer
        rows.append({
            "rid": rid, "arrival": t_arr, "admit": t_adm,
            "slot_start": t_slot, "queue_wait": queue_wait,
            "prefill_wait": prefill_wait, "prefill_service": dur,
            "transfer": transfer, "ttft": ttft})

    def _tot(key: str) -> float:
        return sum(r[key] for r in rows)

    totals = {k: _tot(k) for k in ("queue_wait", "prefill_wait",
                                   "prefill_service", "transfer", "ttft")}
    totals["n"] = len(rows)
    return {"rows": rows, "unattributed": unattributed, "totals": totals}


def tpot_jitter(tracer_or_events) -> Dict[str, object]:
    """Per-token TPOT jitter from decode-slot spans.

    A request's token timeline is its prefill completion followed by the
    ends of every decode/hybrid slot it rode; per-request we report the
    mean inter-token gap and the jitter ``p99_gap - p50_gap``, then
    aggregate p50/p99 over requests."""
    events = _events_of(tracer_or_events)
    first_token: Dict[int, float] = {}
    decode_ends: Dict[int, List[float]] = defaultdict(list)
    for ev in events:
        if ev[0] != "slot":
            continue
        _, t, _iid, kind, dur, rids = ev[:6]
        if kind == "prefill":
            for rid in slot_rids(rids):
                first_token[rid] = t + dur
        elif kind in _DECODE_KINDS:
            for rid in slot_rids(rids):
                decode_ends[rid].append(t + dur)
    per_req = []
    for rid, ft in first_token.items():
        ends = decode_ends.get(rid)
        if not ends:
            continue
        times = [ft] + sorted(ends)
        gaps = [b - a for a, b in zip(times, times[1:])]
        per_req.append({
            "rid": rid, "n_tokens": len(gaps),
            "tpot_mean": sum(gaps) / len(gaps),
            "tpot_jitter": _percentile(gaps, 99) - _percentile(gaps, 50)})
    return {
        "n": len(per_req),
        "tpot_mean_p50": _percentile([r["tpot_mean"] for r in per_req], 50),
        "tpot_jitter_p50": _percentile(
            [r["tpot_jitter"] for r in per_req], 50),
        "tpot_jitter_p99": _percentile(
            [r["tpot_jitter"] for r in per_req], 99),
        "per_request": per_req}


# --------------------------------------------------------------------- #
# interference score (paper Fig. 2)
# --------------------------------------------------------------------- #
def interference(tracer_or_events) -> Dict[str, float]:
    """Decode-step stretch on contiguous slot chains (module docstring).
    Returns ``{score, p50, p99, max, n}`` where score = mean stretch
    - 1.0 (0.0 = decode never waited behind prefill)."""
    per_inst: Dict[int, List[Tuple[float, str, float]]] = defaultdict(list)
    for ev in _events_of(tracer_or_events):
        if ev[0] == "slot":
            per_inst[ev[2]].append((ev[1], ev[3], ev[4]))
    stretches: List[float] = []
    for slots in per_inst.values():
        slots.sort(key=lambda s: s[0])
        prev_end: Optional[float] = None
        prev_decode_end: Optional[float] = None
        for t, kind, dur in slots:
            if prev_end is not None and t - prev_end > _EPS:
                prev_decode_end = None    # idle gap breaks the chain
            if kind in _DECODE_KINDS and dur > 0:
                if prev_decode_end is not None:
                    stretches.append((t + dur - prev_decode_end) / dur)
                prev_decode_end = t + dur
            prev_end = t + dur
    if not stretches:
        return {"score": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0, "n": 0}
    return {
        "score": sum(stretches) / len(stretches) - 1.0,
        "p50": _percentile(stretches, 50),
        "p99": _percentile(stretches, 99),
        "max": max(stretches),
        "n": len(stretches)}


# --------------------------------------------------------------------- #
# run digest (the CLI `summarize` payload)
# --------------------------------------------------------------------- #
def summarize(tracer_or_events) -> Dict[str, object]:
    """Whole-trace digest: event counts by type, time span, instance
    count, attribution totals (+ the exactness check), TPOT jitter
    aggregates, and the interference score."""
    events = _events_of(tracer_or_events)
    counts: Dict[str, int] = defaultdict(int)
    t_lo, t_hi = float("inf"), float("-inf")
    iids = set()
    for ev in events:
        counts[ev[0]] += 1
        if ev[1] >= 0:
            t_lo = min(t_lo, ev[1])
            t_hi = max(t_hi, ev[1])
        if ev[0] == "slot":
            iids.add(ev[2])
    attr = attribution(events)
    tot = attr["totals"]
    # the exactness contract is PER ROW (module docstring): each row's
    # components sum bit-equal to its ttft.  (Cross-row totals are not
    # compared — summing per-component then adding rounds differently
    # than summing per-row ttfts.)
    exact = all(
        r["queue_wait"] + r["prefill_wait"] + r["prefill_service"]
        + r["transfer"] == r["ttft"] for r in attr["rows"])
    jit = tpot_jitter(events)
    return {
        "events": len(events),
        "by_type": dict(sorted(counts.items())),
        "t_span": [t_lo, t_hi] if events and t_lo <= t_hi else [0.0, 0.0],
        "instances": len(iids),
        "attribution": {
            "n": tot["n"], "unattributed": attr["unattributed"],
            "ttft_total": tot["ttft"],
            "exact": exact},
        "tpot": {k: jit[k] for k in ("n", "tpot_mean_p50",
                                     "tpot_jitter_p50", "tpot_jitter_p99")},
        "interference": interference(events)}
