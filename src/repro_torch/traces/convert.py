"""Converters: public LLM-serving trace CSVs -> our tagged JSONL records.

Two public schemas, the ones DistServe/DynaServe-style evaluations use:

* **Azure LLM inference** (AzurePublicDataset, ``AzureLLMInferenceTrace_
  {code,conv}.csv``): ``TIMESTAMP,ContextTokens,GeneratedTokens`` with
  sub-second datetime stamps (up to 7 fractional digits);
* **BurstGPT** (``BurstGPT_*.csv``): ``Timestamp,Model,Request tokens,
  Response tokens,Total tokens,Log Type`` with numeric second stamps.

Both convert to the repo's trace-record dicts —
``{"arrival_time", "prompt_len", "output_len"[, "slo_class"][, "model"]}``
— with arrival times shifted so the first request lands at 0.0 and rows
sorted by arrival.  BurstGPT rows keep the raw upstream model name in
``"model"`` (the fleet router routes on it) independently of the
SLO-class mapping; records without the field serialize byte-identically
to the legacy three/four-key schema.  Records serialize to the same JSONL that
``TraceReplay.from_jsonl`` replays, so a converted trace drives any
simulation cell.  Rows with non-positive context tokens are dropped
(aborted requests); zero generated tokens clamp to 1 (the simulator
models at least the first output token).

Converters are pure line-iterators -> record-lists: no filesystem access
inside, so property tests can drive them with synthetic CSV text.
"""
from __future__ import annotations

import csv
import datetime
import json
from datetime import timezone
from typing import Dict, Iterable, List, Optional, Union

TraceDict = Dict[str, Union[float, int, str]]

AZURE_COLUMNS = ("TIMESTAMP", "ContextTokens", "GeneratedTokens")
BURSTGPT_COLUMNS = ("Timestamp", "Model", "Request tokens",
                    "Response tokens", "Total tokens", "Log Type")

# BurstGPT logs name the upstream model; map each to an SLO class so a
# converted trace can drive the multi-tenant stack (``class_by_model``).
BURSTGPT_CLASS_BY_MODEL = {"ChatGPT": "sharegpt", "GPT-4": "longbench"}


def parse_azure_timestamp(stamp: str) -> float:
    """Azure stamps carry up to 7 fractional digits; ``fromisoformat``
    (py3.10) takes at most 6, so normalize the fraction first.  The
    naive stamp is pinned to UTC — interpreting it in the converting
    machine's local zone would make the same CSV convert differently
    per machine, and a multi-day trace crossing a DST boundary would
    grow a spurious ±1 h gap mid-stream.  Returns POSIX seconds (the
    absolute epoch cancels when ``_finish`` rebases to t=0)."""
    stamp = stamp.strip()
    if "." in stamp:
        whole, frac = stamp.rsplit(".", 1)
        stamp = f"{whole}.{frac[:6].ljust(6, '0')}"
    dt = datetime.datetime.fromisoformat(stamp)
    return dt.replace(tzinfo=timezone.utc).timestamp()


def _finish(rows: List[TraceDict]) -> List[TraceDict]:
    """Sort by arrival and rebase so the first request lands at t=0."""
    rows.sort(key=lambda r: r["arrival_time"])
    if rows:
        t0 = rows[0]["arrival_time"]
        for r in rows:
            r["arrival_time"] = float(r["arrival_time"] - t0)
    return rows


def _require_columns(reader: csv.DictReader, expected, schema: str) -> None:
    have = tuple(reader.fieldnames or ())
    missing = [c for c in expected if c not in have]
    if missing:
        raise ValueError(f"{schema} CSV is missing column(s) {missing}; "
                         f"header was {have}")


def convert_azure(lines: Iterable[str],
                  slo_class: Optional[str] = None) -> List[TraceDict]:
    """Azure LLM-inference CSV lines -> trace records."""
    reader = csv.DictReader(lines)
    _require_columns(reader, AZURE_COLUMNS, "Azure LLM inference")
    rows: List[TraceDict] = []
    for rec in reader:
        try:
            t = parse_azure_timestamp(rec["TIMESTAMP"])
            prompt = int(float(rec["ContextTokens"]))
            out = int(float(rec["GeneratedTokens"]))
        except (TypeError, ValueError):
            continue                      # malformed row: skip, not crash
        if prompt <= 0:
            continue
        row: TraceDict = {"arrival_time": t, "prompt_len": prompt,
                          "output_len": max(1, out)}
        if slo_class:
            row["slo_class"] = slo_class
        rows.append(row)
    return _finish(rows)


def convert_burstgpt(lines: Iterable[str],
                     slo_class: Optional[str] = None,
                     class_by_model: bool = False) -> List[TraceDict]:
    """BurstGPT CSV lines -> trace records.  ``class_by_model`` tags each
    request with the SLO class mapped from its upstream model
    (``BURSTGPT_CLASS_BY_MODEL``); ``slo_class`` pins one tag for every
    row and wins over the mapping."""
    reader = csv.DictReader(lines)
    _require_columns(reader, BURSTGPT_COLUMNS, "BurstGPT")
    rows: List[TraceDict] = []
    for rec in reader:
        try:
            t = float(rec["Timestamp"])
            prompt = int(float(rec["Request tokens"]))
            out = int(float(rec["Response tokens"]))
        except (TypeError, ValueError):
            continue
        if prompt <= 0:
            continue
        row: TraceDict = {"arrival_time": t, "prompt_len": prompt,
                          "output_len": max(1, out)}
        tag = slo_class
        if tag is None and class_by_model:
            tag = BURSTGPT_CLASS_BY_MODEL.get((rec["Model"] or "").strip())
        if tag:
            row["slo_class"] = tag
        model = (rec["Model"] or "").strip()
        if model:
            # raw upstream model name, preserved independently of the
            # class mapping: the fleet router keys pools on it
            row["model"] = model
        rows.append(row)
    return _finish(rows)


CONVERTERS = {"azure": convert_azure, "burstgpt": convert_burstgpt}


def records_to_jsonl(records: Iterable[TraceDict]) -> List[str]:
    """One JSONL line per record, in the exact key order
    ``TraceReplay.from_jsonl`` documents (tag last, only when present)."""
    out = []
    for r in records:
        d = {"arrival_time": r["arrival_time"],
             "prompt_len": r["prompt_len"],
             "output_len": r["output_len"]}
        if r.get("slo_class"):
            d["slo_class"] = r["slo_class"]
        if r.get("model"):
            d["model"] = r["model"]
        out.append(json.dumps(d))
    return out


def write_jsonl(records: Iterable[TraceDict], path) -> None:
    with open(path, "w") as f:
        for line in records_to_jsonl(records):
            f.write(line + "\n")
