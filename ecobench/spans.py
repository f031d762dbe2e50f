"""Run a cell with the program's own spans on and print what they read.

    python3 ecobench/spans.py --workload <cell> --seeds 1,2 --seconds 51 \
        --trace 1 [--spans 1]

Each run is ``run_cell``'s, at the cell's rate, with its own ``Tracer`` on
the window's ``serve`` (``repro_torch.serving.spans``: the loop's ``run``,
``wait`` and ``refuse`` tuples) and, with ``--trace 1``, the window's last
15% profiled with the program's ``record_function`` ranges in the trace.
One JSON line a run: ``correct``, ``output_tokens_s``, ``decode_step_ms``,
``loop_sleep_share`` (the clock's), ``queue_wait_p90_s``, the readings of
``harness/program.py`` (``slot_wait_share``, ``queued_arrival_share``,
``decode_host_share``, ``idle_in_decode_share``), refusals by
constraint, decode seconds executed over modeled, the 90th percentile of
how late the loop submitted an arrival, and two cross-checks: the
program's wait seconds less the clock's slept seconds (% of the window)
and decode ``run`` tuples less the recorder's decode steps.
``--spans 0`` runs without the tracer, for what tracing costs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def run(name: str, seed: int, seconds: float, trace: bool, *,
        spans: bool = True, rate=None, t_start=None, **kw) -> dict:
    """One run of ``name``; ``kw`` goes to ``run_cell`` (CPU tests: a
    ``shrink``, ``device``, ``drain``)."""
    from ecobench.harness import bench, program, stats

    if rate is None:
        rate = bench.cell_spec(name)["cell"]["rate"]
    out = bench.run_cell(
        name, seed, seconds, trace, rate=rate, spans=spans,
        t_start=time.perf_counter() if t_start is None else t_start,
        log=lambda s: print(s, file=sys.stderr), **kw)
    r = out["run"]
    row = {"workload": name, "seed": seed, "trace": int(trace),
           "spans": int(spans), "correct": out["correct"],
           "output_tokens_s": stats.output_tokens(r) / r.window_s,
           "setup_s": r.setup_s, "decode_step_ms": stats.mean_decode_ms(r),
           "loop_sleep_share": 100.0 * r.slept_s / r.window_s,
           "queue_wait_p90_s": stats.nearest_rank(stats.queue_waits(r), 90),
           "device_idle_share": stats.idle_share(r)}
    if not spans:
        return row
    ev = r.events
    waits = sum(w[2] for w in ev if w[0] == "wait")
    # the loop submits an arrival at its own time, after the slot it was
    # running when the request fell due
    due = {q["rid"]: q["arrival"] for q in r.requests}
    late = [e[1] - due[e[2]] for e in ev if e[0] == "arrive"]
    row.update(
        slot_wait_share=program.slot_wait_share(ev, r.window_s),
        queued_arrival_share=program.queued_arrival_share(ev),
        decode_host_share=program.decode_host_share(ev),
        idle_in_decode_share=program.idle_in_decode_share(r.trace),
        refusals=program.refusals(ev),
        decode_over_modeled=program.decode_over_modeled(ev),
        arrival_late_p90_s=stats.nearest_rank(late, 90),
        wait_less_slept_share=100.0 * (waits - r.slept_s) / r.window_s,
        decode_runs_less_steps=sum(1 for e in ev if e[0] == "run"
                                   and e[3] == "decode") - len(r.decodes),
        waits_by_cause={c: sum(w[2] for w in ev if w[0] == "wait"
                               and w[3] == c)
                        for c in ("slot", "arrival", "forced")})
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    # as run.py: every cache of the run inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        row = run(args.workload, seed, args.seconds, bool(args.trace),
                  spans=bool(args.spans), t_start=T_START if i == 0 else None)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
