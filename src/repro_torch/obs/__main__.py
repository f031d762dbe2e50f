"""Flight-recorder CLI: ``python -m repro_torch.obs <cmd> <trace.jsonl>``.

    summarize    print the whole-trace digest (event counts, attribution
                 totals + exactness check, TPOT jitter, interference)
    attribution  print the per-request TTFT attribution table
    export       convert a JSONL trace to Chrome-trace/Perfetto JSON
                 (``--perfetto`` / ``-o out.json``)

All commands read the JSONL format ``repro_torch.obs.export.write_jsonl``
produces (``run_once(trace=path)``, ``bench_trace --smoke``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs.export import read_jsonl, write_chrome_trace
from repro_torch.obs.metrics import attribution, summarize


def _cmd_summarize(args) -> int:
    events, meta = read_jsonl(args.trace)
    digest = summarize(events)
    if meta:
        digest["meta"] = meta
    json.dump(digest, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0 if digest["attribution"]["exact"] else 1


def _cmd_attribution(args) -> int:
    events, _ = read_jsonl(args.trace)
    attr = attribution(events)
    rows = attr["rows"][: args.limit] if args.limit else attr["rows"]
    if args.json:
        json.dump({"rows": rows, "totals": attr["totals"],
                   "unattributed": attr["unattributed"]},
                  sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    cols = ("rid", "arrival", "queue_wait", "prefill_wait",
            "prefill_service", "transfer", "ttft")
    print("  ".join(f"{c:>15}" for c in cols))
    for r in rows:
        print("  ".join(
            f"{r[c]:>15}" if c == "rid" else f"{r[c]:>15.6f}"
            for c in cols))
    tot = attr["totals"]
    # per-row exactness is the contract (repro_torch.obs.metrics docstring)
    exact = all(
        r["queue_wait"] + r["prefill_wait"] + r["prefill_service"]
        + r["transfer"] == r["ttft"] for r in attr["rows"])
    print(f"-- {tot['n']} attributed, {attr['unattributed']} unattributed;"
          f" ttft_total={tot['ttft']:.9f} per-row exact={exact}")
    return 0 if exact else 1


def _cmd_export(args) -> int:
    events, meta = read_jsonl(args.trace)
    out = args.out or (str(args.trace).rsplit(".jsonl", 1)[0]
                       + ".perfetto.json")
    n = write_chrome_trace(events, out, meta=meta)
    print(f"wrote {n} trace events -> {out}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Flight-recorder trace tooling")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="whole-trace digest as JSON")
    p.add_argument("trace")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("attribution", help="per-request TTFT attribution")
    p.add_argument("trace")
    p.add_argument("--limit", type=int, default=0,
                   help="print at most N rows (0 = all)")
    p.add_argument("--json", action="store_true",
                   help="emit JSON instead of the table")
    p.set_defaults(fn=_cmd_attribution)

    p = sub.add_parser("export",
                       help="convert to Chrome-trace/Perfetto JSON")
    p.add_argument("trace")
    p.add_argument("--perfetto", action="store_true",
                   help="Perfetto-loadable Chrome-trace JSON (the only "
                        "format; flag kept explicit for readability)")
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(fn=_cmd_export)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
