"""Run one cell of the benchmark once and print its result line.

    python3 ecobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits non-zero, printing no result, without
a CUDA device (or with fewer than the cell asks for), and if any module of
JAX or of the JAX package is loaded once the window has closed.  The last
line of standard output is the result; the last lines of standard error
are the numbers compared, each with its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    sys.path[:0] = [str(REPO / "src"), str(REPO)]

    from ecobench.harness.bench import (cell_spec, forbidden_modules,
                                        run_cell)
    chips = cell_spec(args.workload)["entry"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ecobench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START,
                   log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"ecobench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
