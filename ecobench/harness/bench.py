"""One run of one cell: set-up, the window, the trace, the judgement.

``run_cell`` does everything but the look for a chip, so the CPU tests
drive it at a tiny size (``shrink``) with faults planted underneath.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional

from ecobench.harness import files, judge, traffic
from ecobench.harness.clock import BenchClock
from ecobench.harness.model import family_of, load_config

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")             # whole top-level names
TRACE_FROM = 0.85     # the traced run profiles the window from here to its close


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    model: object               # the family's Model
    family: ModuleType
    dtype: str
    slo: dict
    seconds: float
    window_s: float
    close: float
    setup_s: float
    slept_s: float
    requests: List[dict]
    prefills: List[tuple]
    decodes: List[tuple]
    # the traced run's: the kernel files' counted calls by name, the
    # trace's reduction (on a card), the program's tuples and counters
    calls: Dict[str, List[tuple]] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None
    events: Optional[list] = None
    meta: Optional[dict] = None


def cell_spec(name: str) -> dict:
    """The cell's entry with its configuration, traffic and rate files."""
    bench = files.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = files.read_json("cells", name)
    mix = files.read_json("traffic", entry["traffic"])
    return {"entry": entry, "cell": cell, "mix": mix,
            "conf": load_config(entry["config"]), "bench": bench}


def metric_names(bench: dict, cell: str, trace: bool) -> List[str]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``; a name with no file of its own,
    such as ``ttft_p50_s.sat`` (the same quantity in cells that report
    another end-to-end metric), reads through the file of its name less
    its last dotted part."""
    try:
        return files.module("metrics", name).read
    except FileNotFoundError:
        if "." not in name:
            raise
        return files.module("metrics", name.rsplit(".", 1)[0]).read


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def request_record(r, a: traffic.Arrival, last_token) -> dict:
    from repro_torch.core.request import RequestState
    return {"rid": r.rid, "arrival": r.arrival_time,
            "admitted": r.admitted_time, "first": r.first_token_time,
            "second": r.second_token_time, "finish": r.finish_time,
            "tokens_generated": r.tokens_generated,
            "generated": list(r.generated or []),
            "finished": r.state == RequestState.FINISHED,
            "asked": a.output_len, "prompt_len": a.prompt_len,
            "prompt_tokens": a.prompt_tokens,
            "last_token": last_token.get(r.rid)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             shrink: Optional[Callable[[dict], dict]] = None,
             fault: Optional[Callable] = None, control: bool = False,
             rate: Optional[float] = None, drain: bool = False,
             spans: Optional[bool] = None, log=print) -> dict:
    """One run: returns the result line's dict, with the numbers compared
    under ``"checks"`` (last).  ``shrink`` edits the spec (tests at a tiny
    size); ``fault(server)`` breaks the program underneath (tests);
    ``control`` also reads the float8 control's widest gap on the same
    sample (``limits.py``); ``rate`` replaces the cell's (``sweep.py``).
    The record the readers see is kept under ``"run"`` when ``rate`` or
    ``control`` is given.  ``drain`` serves every request to its end
    (CPU tests: what finishes then does not hang on the host's speed).
    ``spans`` (default: ``trace``) gives the window's serve a ``Tracer``
    (``spans.py``: what the tracer costs)."""
    import torch
    from ecobench.harness import serve as S

    spec = cell_spec(name)
    if shrink is not None:
        spec = shrink(spec)
    conf, mix, cell = spec["conf"], spec["mix"], spec["cell"]
    fam = family_of(conf)
    m = fam.Model(**conf["model"])
    dtype_name = conf["engine"]["dtype"]
    dtype = getattr(torch, dtype_name)
    on_card = device != "cpu"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        marks.append(("cuda", time.perf_counter()))
    clock = BenchClock()
    rec = S.Log()
    server, w = S.build(conf, m, mix,
                        lambda: fam.draw(m, seed, dtype, device),
                        device, clock, rec, dtype)
    engines = S.engines_of(server)
    marks.append(("server", time.perf_counter()))
    if fault is not None:
        fault(server)
    vocab = m.vocab

    # ---- warm-up: every path once, each executor's gains measured ---- #
    warm = traffic.warmup(mix, seed, vocab, int(mix.get("warmup_requests",
                                                        4)))
    S.prime(engines[0], warm)
    S.warm_engines(engines, warm, int(mix.get("warmup_output", 8)))
    server.serve(S.to_requests(warm), clock=BenchClock())
    if trace and on_card:
        from ecobench.harness.trace import warm_profiler
        warm_profiler(device)

    marks.append(("warmup", time.perf_counter()))
    arrivals = traffic.window(mix, rate or cell["rate"], seconds, seed,
                              vocab)
    reqs = S.to_requests(arrivals)
    shims = sub = tracer = None
    trace_path = None
    if trace:
        from ecobench.harness.trace import Shims, SubWindow
        shims = Shims()
        shims.install(engines)
        if on_card:
            fd, trace_path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
        sub = SubWindow(TRACE_FROM * seconds, shims, trace_path)
        clock.on_time = sub
        clock.sleep_span = sub.sleep_span
    if (trace if spans is None else spans):
        from repro_torch.obs.events import Tracer
        tracer = Tracer()
    rec.clear()
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # ---- the window --------------------------------------------------- #
    stats = server.serve(reqs, clock=clock,
                         horizon=float("inf") if drain else seconds,
                         tracer=tracer)
    if tracer is not None:
        tracer.clock = None     # it reads the loop, which holds the engines
    # a window whose work ended early still lasts its seconds
    window_s = max(time.perf_counter() - clock.t0, seconds)
    close = window_s
    if sub is not None and sub.state == "on":
        sub.end()                   # after the close: stop and export
    if on_card:
        torch.cuda.synchronize()
        mem_peak = torch.cuda.max_memory_allocated()
    else:
        mem_peak = 0
    if shims is not None:
        shims.uninstall()

    by_rid = {a.rid: a for a in arrivals}
    records = [request_record(r, by_rid[r.rid], rec.last_token)
               for r in reqs]
    refused = len(stats.rejected)
    run = Run(model=m, family=fam, dtype=dtype_name, slo=mix["slo"],
              seconds=seconds, window_s=window_s, close=close,
              setup_s=setup_s, slept_s=clock.slept, requests=records,
              prefills=list(rec.prefills), decodes=list(rec.decodes))
    if shims is not None:
        run.calls = shims.calls
    if tracer is not None:
        run.events, run.meta = tracer.events, tracer.meta
    if trace_path and sub.state == "done":
        from ecobench.harness.trace import read
        run.trace = read(trace_path)
    if trace_path:
        os.unlink(trace_path)

    # ---- free the program, then judge -------------------------------- #
    server.shutdown()
    del server, engines, stats, reqs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    eos = conf["engine"]["eos_token_id"]
    errors = judge.token_count_errors(records, eos,
                                      conf["engine"]["max_seq_len"])
    check = mix["check"]
    picked = judge.sample([r for r in records if r["finished"]], seed,
                          check["tokens"], check["requests"])
    t_ref = time.perf_counter()
    served, ctrl = judge.gaps(fam.logits_at, w, m, picked,
                              control_too=control)
    ref_s = time.perf_counter() - t_ref
    gap = judge.widest(served)
    limit = conf["limits"]["widest_logit_gap"]
    wrong = sum(1 for g in served if len(g) and float(g.max()) > limit)
    n_compared = sum(len(g) for g in served)

    late = 0
    if mix["regime"] == "tail":
        late = sum(1 for r in records if r["first"] is None
                   and close - r["arrival"] > mix["slo"]["ttft_s"])
    failed = refused + errors + wrong + late
    checks = {
        "widest_logit_gap": {"value": gap, "limit": limit},
        "token_count_errors": {"value": errors, "limit": 0},
        "tokens_compared": {"value": n_compared,
                            "limit": check["min_compared"]},
    }
    correct = (gap <= limit and errors == 0
               and n_compared >= check["min_compared"])

    names = metric_names(spec["bench"], name, trace)
    units = {mm["name"]: mm["unit"] for mm in
             spec["bench"]["end_to_end"] + spec["bench"]["per_layer"]}
    metrics: Dict[str, dict] = {}
    for mn in names:
        v = load_reader(mn)(run)
        if v is not None:
            metrics[mn] = {"value": float(v), "unit": units[mn]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    log(f"ecobench: {name} seed {seed}: {len(records)} requests, "
        f"{len(picked)} compared ({n_compared} tokens, reference "
        f"{ref_s:.1f} s), refused {refused}, late {late}, "
        f"setup {setup_s:.1f} s ("
        + ", ".join(f"{k} {t - marks[i][1]:.1f}"
                    for i, (k, t) in enumerate(marks[1:]))
        + f"), set-up peak {setup_peak / 1e9:.2f} GB, window "
        f"{window_s:.2f} s, slept {run.slept_s:.2f} s, "
        f"{len(run.decodes)} decode steps, {len(run.prefills)} prefills")
    if control:
        out["control_widest_logit_gap"] = judge.widest(ctrl)
    if control or rate:
        out["run"] = run
    out["checks"] = checks
    return out
