"""Find a cell's knee once: serve its configuration and traffic at each of
a list of rates, one fresh server a rate, in one process, and print what
each rate did.

    python3 ecobench/sweep.py --workload <cell> --rates 2,3,4,5 \
        --seconds 30 --seed <n>

The knee is the highest rate at which at least 90% of the requests due
meet both of the traffic's limits (a request without a first token at the
close, waiting past the TTFT limit, misses) and the backlog (requests due
without a first token) at the close is no larger than at the window's
middle by more than ``max(2, 5% of the requests)``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def backlog(run, t: float) -> int:
    return sum(1 for r in run.requests if r["arrival"] <= t
               and (r["first"] is None or r["first"] > t))


def summary(run) -> dict:
    from ecobench.harness import stats
    slo = run.slo
    met = 0
    for r in run.requests:
        tp = stats.tpot(r)
        if r["first"] is None:
            ok = False
        else:
            ok = (r["first"] - r["arrival"] <= slo["ttft_s"]
                  and (tp is None or tp <= slo["tpot_s"]))
        met += ok
    n = len(run.requests)
    mid, end = backlog(run, 0.5 * run.seconds), backlog(run, run.close)
    return {"requests": n, "attainment": met / max(1, n),
            "ttft_p50_s": stats.nearest_rank(stats.ttfts(run), 50),
            "ttft_p90_s": stats.nearest_rank(stats.ttfts(run), 90),
            "tpot_p90_ms": 1e3 * (stats.nearest_rank(stats.tpots(run), 90)
                                  or 0.0),
            "output_tokens_s": stats.output_tokens(run) / run.window_s,
            "backlog_mid": mid, "backlog_close": end,
            "stable": end - mid <= max(2, 0.05 * n),
            "decode_step_ms": stats.mean_decode_ms(run),
            "loop_sleep_share": 100.0 * run.slept_s / run.window_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    from ecobench.harness.bench import run_cell
    for rate in [float(x) for x in args.rates.split(",")]:
        out = run_cell(args.workload, args.seed, args.seconds, False,
                       t_start=time.perf_counter(), rate=rate,
                       log=lambda s: print(s, file=sys.stderr))
        row = {"rate": rate, "correct": out["correct"], **summary(out["run"])}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
