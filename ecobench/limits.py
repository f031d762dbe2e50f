"""Readings for a configuration's output limit: for each seed, one short
run of a cell (the cell's load, the timed path) whose served tokens are
judged against the plain reference, and on the same sample the float8
control's widest gap.  One process for all seeds.

    python3 ecobench/limits.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 20

Prints one JSON line a seed: the program's widest gap and, where asked,
the control's.  The limit in ``configs/<name>.json`` is set from these
(PERF.md gives the readings).
"""
import time

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    from ecobench.harness.bench import run_cell
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = run_cell(args.workload, seed, args.seconds, False,
                       t_start=time.perf_counter(), control=seed in ctrl,
                       log=lambda s: print(s, file=sys.stderr))
        row = {"seed": seed,
               "widest_logit_gap": out["checks"]["widest_logit_gap"]["value"],
               "tokens_compared": out["checks"]["tokens_compared"]["value"],
               "control_widest_logit_gap":
                   out.get("control_widest_logit_gap")}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
