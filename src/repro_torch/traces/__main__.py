"""Trace-converter CLI.

    PYTHONPATH=src python -m repro_torch.traces azure in.csv out.jsonl \
        --rate 6.0 --horizon 120 --stats

    PYTHONPATH=src python -m repro_torch.traces burstgpt in.csv out.jsonl \
        --class-by-model --sample 0.25 --seed 7

Converts a public-schema CSV (``azure`` | ``burstgpt``) to the repo's
tagged JSONL, applying transforms in the fixed order
downsample -> rescale/normalize -> clip, and prints the audit summary
(``--stats``) so the converted trace is reviewable before it drives a
sweep.  The output replays with ``TraceReplay.from_jsonl`` or the
``"replay"`` scenario kind (``trace=PATH``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.traces import (CONVERTERS, clip_horizon, downsample,
                          format_stats, normalize_rate, rescale_time,
                          trace_stats, write_jsonl)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.traces",
        description="Convert public LLM-serving trace CSVs to the "
                    "repo's tagged JSONL trace format.")
    ap.add_argument("schema", choices=sorted(CONVERTERS),
                    help="source CSV schema")
    ap.add_argument("csv_in", help="input CSV path")
    ap.add_argument("jsonl_out", help="output JSONL path")
    ap.add_argument("--slo-class", default=None,
                    help="tag every request with this SLO class")
    ap.add_argument("--class-by-model", action="store_true",
                    help="(burstgpt) tag requests by upstream model")
    ap.add_argument("--sample", type=float, default=None, metavar="F",
                    help="deterministically keep fraction F of rows")
    ap.add_argument("--seed", type=int, default=0,
                    help="downsampling seed")
    ap.add_argument("--rescale", type=float, default=None, metavar="X",
                    help="multiply arrival times by X (<1 compresses)")
    ap.add_argument("--rate", type=float, default=None, metavar="R",
                    help="normalize the mean arrival rate to R req/s "
                         "(overrides --rescale)")
    ap.add_argument("--horizon", type=float, default=None, metavar="T",
                    help="clip arrivals at/after T seconds (applied "
                         "after rate normalization)")
    ap.add_argument("--stats", action="store_true",
                    help="print the trace_stats audit summary")
    args = ap.parse_args(argv)

    kw = {}
    if args.slo_class:
        kw["slo_class"] = args.slo_class
    if args.class_by_model:
        if args.schema != "burstgpt":
            ap.error("--class-by-model applies to the burstgpt schema")
        kw["class_by_model"] = True
    with open(args.csv_in) as f:
        records = CONVERTERS[args.schema](f, **kw)
    if args.sample is not None:
        records = downsample(records, args.sample, seed=args.seed)
    if args.rate is not None:
        records = normalize_rate(records, args.rate)
    elif args.rescale is not None:
        records = rescale_time(records, args.rescale)
    if args.horizon is not None:
        records = clip_horizon(records, args.horizon)
    write_jsonl(records, args.jsonl_out)
    print(f"wrote {len(records)} records to {args.jsonl_out}")
    if args.stats:
        print(format_stats(trace_stats(records)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
