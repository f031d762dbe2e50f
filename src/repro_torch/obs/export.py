"""Flight-recorder persistence: JSONL codec + Chrome-trace/Perfetto export.

``SCHEMA`` is the single source of truth for the positional fields of
every event tuple the ``Tracer`` emits (``repro_torch.obs.events``).  The JSONL
codec writes one named-field object per event (first line = a meta
header carrying the schema version and the tracer's ``meta`` dict), and
``read_jsonl`` rebuilds the exact tuples — the round trip is lossless
for every JSON-representable payload, which all emission sites keep to.

``chrome_trace`` renders the events in the Chrome Trace Event JSON
format Perfetto loads directly (https://ui.perfetto.dev -> open trace):
slot spans become complete ("X") events on one track per instance,
request/instance/fault/control/transport events become instants ("i"),
and the per-instance state samples become counter ("C") tracks (KV
occupancy, queue depth, decode batch utilization, prefill backlog).
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

from repro_torch.obs.events import slot_rids

SCHEMA_VERSION = 1

# etype -> positional field names AFTER the (etype, t) prefix; must match
# the append sites in repro_torch.obs.events.Tracer exactly.
SCHEMA: Dict[str, Tuple[str, ...]] = {
    "arrive":    ("rid", "slo_class", "model"),
    "admit":     ("rid", "iid"),
    "enqueue":   ("rid",),
    "drain":     ("rid", "iid"),
    "finish":    ("rid",),
    "fail":      ("rid", "reason"),
    "requeue":   ("rid",),
    "migrate":   ("rid", "src", "dst"),
    "handoff":   ("iid", "rids"),
    "slot":      ("iid", "kind", "dur", "rids", "kv_used", "kv_cap",
                  "n_pending", "pending_tokens", "n_decoding", "queue_len",
                  "max_decode_batch"),
    "instance":  ("iid", "what"),
    "fault":     ("kind", "iid"),
    "control":   ("what", "value"),
    "transport": ("what", "kind", "src", "dst"),
    "op":        ("what", "work", "extra", "dt"),
}

# fields decoded back to tuples (JSON has no tuple type)
_TUPLE_FIELDS = frozenset(["rids"])


def _events_of(tracer_or_events) -> List[tuple]:
    ev = getattr(tracer_or_events, "events", tracer_or_events)
    return list(ev)


def to_dicts(tracer_or_events) -> List[dict]:
    """Named-field view of the event list (the JSONL body shape)."""
    rows = []
    for ev in _events_of(tracer_or_events):
        etype, t = ev[0], ev[1]
        fields = SCHEMA.get(etype)
        if fields is None:                       # forward compat: keep raw
            rows.append({"e": etype, "t": t, "args": list(ev[2:])})
            continue
        row = {"e": etype, "t": t}
        for name, val in zip(fields, ev[2:]):
            # rids may be a live request batch (hot-path economy, see
            # events.Tracer.slot) — normalize to ids here
            row[name] = (list(slot_rids(val)) if name in _TUPLE_FIELDS
                         else val)
        rows.append(row)
    return rows


def write_jsonl(tracer_or_events, path) -> int:
    """Write the trace as JSONL (meta header + one object per event).
    Returns the number of events written."""
    import os
    meta = dict(getattr(tracer_or_events, "meta", {}) or {})
    rows = to_dicts(tracer_or_events)
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(json.dumps({"schema": SCHEMA_VERSION, "meta": meta,
                             "events": len(rows)}, sort_keys=True) + "\n")
        for row in rows:
            fh.write(json.dumps(row, sort_keys=True) + "\n")
    return len(rows)


def read_jsonl(path) -> Tuple[List[tuple], dict]:
    """Rebuild ``(events, meta)`` from a JSONL trace file — the inverse
    of ``write_jsonl`` (tuples restored, header consumed)."""
    events: List[tuple] = []
    meta: dict = {}
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if i == 0 and "schema" in row and "e" not in row:
                meta = dict(row.get("meta", {}))
                continue
            etype = row["e"]
            fields = SCHEMA.get(etype)
            if fields is None:
                events.append((etype, row["t"], *row.get("args", ())))
                continue
            vals = []
            for name in fields:
                v = row.get(name)
                if name in _TUPLE_FIELDS and isinstance(v, list):
                    v = tuple(v)
                vals.append(v)
            events.append((etype, row["t"], *vals))
    return events, meta


# --------------------------------------------------------------------- #
# Chrome-trace / Perfetto export
# --------------------------------------------------------------------- #
_US = 1e6          # trace-event timestamps are microseconds
_PID_SIM = 1       # one process row: the simulated pool
_CTRL_TID = 10_000  # control-plane instants live on their own track


def _us(t: float) -> float:
    return round(max(t, 0.0) * _US, 3)


def chrome_trace(tracer_or_events, meta: dict = None) -> dict:
    """Render the events as a Chrome Trace Event JSON object
    (``{"traceEvents": [...]}``) loadable by Perfetto and
    ``chrome://tracing``.  One thread track per instance carrying its
    slot spans + counters; instants for lifecycle/fault/control events.
    """
    events = _events_of(tracer_or_events)
    if meta is None:
        meta = dict(getattr(tracer_or_events, "meta", {}) or {})
    out: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": _PID_SIM,
        "args": {"name": meta.get("name", "repro sim pool")}}]
    seen_tids = set()

    def tid_of(iid) -> int:
        tid = int(iid) if iid is not None else _CTRL_TID
        if tid not in seen_tids:
            seen_tids.add(tid)
            out.append({"name": "thread_name", "ph": "M", "pid": _PID_SIM,
                        "tid": tid,
                        "args": {"name": ("control" if tid == _CTRL_TID
                                          else f"instance {tid}")}})
        return tid

    def instant(name: str, t: float, tid: int, args: dict) -> None:
        out.append({"name": name, "ph": "i", "s": "t", "pid": _PID_SIM,
                    "tid": tid, "ts": _us(t), "args": args})

    for ev in events:
        etype, t = ev[0], ev[1]
        if etype == "slot":
            (iid, kind, dur, rids, kv_used, kv_cap, n_pending,
             pending_tokens, n_decoding, queue_len, max_batch) = ev[2:]
            rids = slot_rids(rids)
            tid = tid_of(iid)
            out.append({
                "name": kind, "ph": "X", "pid": _PID_SIM, "tid": tid,
                "ts": _us(t), "dur": round(dur * _US, 3),
                "args": {"rids": list(rids), "batch": len(rids),
                         "kv_used": kv_used, "queue_len": queue_len}})
            util = (n_decoding / max_batch) if max_batch else 0.0
            for cname, val in (("kv_occupancy",
                                kv_used / kv_cap if kv_cap else 0.0),
                               ("queue_depth", queue_len),
                               ("decode_batch_util", util),
                               ("prefill_backlog_tokens", pending_tokens)):
                out.append({"name": f"{cname} (inst {iid})", "ph": "C",
                            "pid": _PID_SIM, "tid": tid, "ts": _us(t),
                            "args": {cname: round(float(val), 6)}})
        elif etype == "instance":
            iid, what = ev[2:]
            instant(f"instance:{what}", t, tid_of(iid), {"iid": iid})
        elif etype == "fault":
            kind, iid = ev[2:]
            instant(f"fault:{kind}", t,
                    tid_of(iid) if iid is not None else _CTRL_TID,
                    {"iid": iid})
        elif etype == "control":
            what, value = ev[2:]
            instant(f"control:{what}", t, tid_of(None),
                    {"value": value if isinstance(
                        value, (int, float, str, bool, type(None)))
                        else str(value)})
        elif etype == "transport":
            what, kind, src, dst = ev[2:]
            instant(f"transport:{what}", t, tid_of(None),
                    {"kind": kind, "src": src, "dst": dst})
        elif etype in ("fail", "migrate"):
            instant(f"request:{etype}", t, tid_of(None),
                    {SCHEMA[etype][0]: ev[2]})
        # arrive/admit/enqueue/drain/finish/handoff/op stay out of the
        # rendered trace (per-request volume would swamp the UI); they
        # remain in the JSONL for the attribution tooling.
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome_trace(tracer_or_events, path, meta: dict = None) -> int:
    """Write the Perfetto-loadable JSON; returns the traceEvents count."""
    import os
    doc = chrome_trace(tracer_or_events, meta=meta)
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    return len(doc["traceEvents"])
