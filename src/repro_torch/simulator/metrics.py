"""Goodput measurement: max request rate sustaining an SLO-attainment
percentile (the paper's Fig. 8 metric).

Multi-tenant contract: when ``slo`` is a heterogeneous ``SLOClassSet``,
``run_once`` scores every request against its OWN class budget and
additionally reports the per-class attainment grid plus the
min-over-classes scalar, and ``goodput`` bisects on that minimum — the
frontier is capped by the WORST-served tenant, so a strategy cannot buy
aggregate attainment by starving one class (the "Inference without
Interference" measurement discipline).  Single-class sets are
bit-identical to passing the bare ``SLO``.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.slo import (SLO, as_slo_class_set, attainment,
                            attainment_summary, percentile_latencies,
                            request_meets_slo)
from repro_torch.simulator.engine import SimulationEngine
from repro_torch.simulator.workload import WorkloadGen, WorkloadProfile


def as_scenario(workload, rate: float, seed: int):
    """Normalize the workload argument to something with ``generate``.

    Accepts a ``WorkloadProfile`` (wrapped in a Poisson ``WorkloadGen`` at
    ``rate`` — the original behaviour), any scenario object exposing
    ``generate(duration)`` (see ``repro_torch.simulator.scenarios``), or a
    factory callable ``(rate, seed) -> scenario`` for rate sweeps over
    non-stationary shapes.
    """
    if isinstance(workload, WorkloadProfile):
        return WorkloadGen(workload, rate, seed=seed)
    if hasattr(workload, "generate"):
        return workload
    if callable(workload):
        return workload(rate, seed)
    raise TypeError(f"cannot build a scenario from {type(workload)!r}")


def phase_edges(duration: float, warmup: float, phases: int):
    """Boundaries of the per-phase attainment windows: ``phases`` equal
    slices of the scored span [warmup, duration).  The one definition
    shared by ``run_once`` and consumers that map other per-phase data
    (controller trajectories, offline-optimal sweeps) onto the same
    windows."""
    return [warmup + (duration - warmup) * i / phases
            for i in range(phases + 1)]


def run_once(system_factory: Callable[[], object], workload,
             rate: float, slo, duration: float = 240.0,
             warmup: float = None, seed: int = 0,
             control=None, phases=None, faults=None,
             trace=None) -> Dict[str, float]:
    """One simulation at a fixed rate.  ``slo`` is a bare ``SLO`` or an
    ``SLOClassSet``; a heterogeneous set adds ``attainment_by_class``
    (per-class grid) and ``attainment_min`` (worst class) to the row.

    ``control`` installs the closed-loop autoscaler (``repro_torch.control``):
    a controller spec string (``"band"``, ``"threshold"``,
    ``"band:max=8,delay=2"``) or a ``ScalingController`` instance; the
    row then carries the recorded ``timeline`` (scale events + instance
    trajectory).  ``phases`` splits the scored window into attainment
    phases — an int for equal windows over [warmup, duration) or an
    explicit boundary sequence — adding ``attainment_by_phase`` (each
    phase scored over requests *arriving* in it, unfinished ones
    counting as misses, so post-shift dips are visible) and the
    min-over-phases scalar ``attainment_phase_min``.

    ``faults`` injects a seeded fault schedule (``repro_torch.faults``): a spec
    string (``"crash:t=14;spot:mtbf=20,notice=2"``), a named interruption
    trace (``"itrace:gentle"``, ``repro_torch.simulator.scenarios``), or a
    prebuilt ``FaultSchedule``; the row then carries the injector's
    ``faults`` summary (applied events + failure-policy stats).  Faulted
    requests that never finish count as misses exactly like any other
    unfinished request.

    ``trace`` attaches the flight recorder (``repro_torch.obs``): ``True``
    captures in memory, a ``Tracer`` instance is attached as-is, and a
    path string/``PathLike`` additionally writes the events as JSONL at
    the end of the run.  Tracing is observation-only — it never touches
    the event timeline — and the captured events are reported under
    ``out["trace"]`` (count + path), a key the runner excludes from
    golden rows so the axis stays seed-neutral."""
    system = system_factory()
    warmup = duration * 0.15 if warmup is None else min(warmup,
                                                        duration * 0.5)
    classes = as_slo_class_set(slo)
    harness = None
    gen = as_scenario(workload, rate, seed)
    # a prebuilt scenario carries its own rate; report that one so a
    # mismatched ``rate`` argument can't mislabel the result row
    scen_rate = getattr(getattr(gen, "arrivals", None), "rate", None)
    if scen_rate is None:
        scen_rate = getattr(gen, "rate", None)  # MixedScenario/WorkloadGen
    if scen_rate is not None:
        rate = scen_rate
    reqs = gen.generate(duration)
    engine = SimulationEngine(system)
    tracer = None
    trace_path = None
    if trace is not None and trace is not False:
        # lazy for the same reason as control/faults: untraced cells
        # stay as cheap as before the obs layer existed
        from repro_torch.obs.events import Tracer, attach_tracer
        if isinstance(trace, Tracer):
            tracer = trace
        else:
            tracer = Tracer()
            if trace is not True:          # str / PathLike destination
                trace_path = trace
        attach_tracer(tracer, engine=engine, system=system)
    if control is not None:
        if hasattr(system, "pools"):
            # a fleet cell: capacity decisions are budget-constrained
            # rebalancing across the member pools, not single-pool
            # scaling (control spec "rebalance[:k=v,...]")
            from repro_torch.fleet import FleetRebalanceHarness
            harness = FleetRebalanceHarness(system, engine,
                                            control).attach()
        else:
            # imported lazily: repro_torch.control depends only on repro_torch.core,
            # but static cells must not pay (or require) the import
            from repro_torch.control import ControlLoopHarness, make_controller
            harness = ControlLoopHarness(
                system, engine, make_controller(control)).attach()
    injector = None
    if faults:
        # lazy for the same reason: fault-free cells stay import-free
        from repro_torch.faults import FaultInjector, make_fault_schedule
        if hasattr(faults, "events"):          # prebuilt FaultSchedule
            schedule = faults
        else:
            spec_str = str(faults)
            if spec_str.startswith("itrace:"):
                from repro_torch.simulator.scenarios import INTERRUPTION_TRACES
                spec_str = INTERRUPTION_TRACES[spec_str[len("itrace:"):]]
            schedule = make_fault_schedule(spec_str, seed=seed,
                                           duration=duration)
        injector = FaultInjector(schedule, system).attach(engine)
    # allow in-flight work to drain past the arrival window
    engine.run(reqs, horizon=duration * 2.5)
    scored = [r for r in engine.finished if r.arrival_time >= warmup]
    submitted = [r for r in reqs if r.arrival_time >= warmup]
    if not submitted:            # vacuously fine at negligible rates
        return {"rate": rate, "attainment": 1.0, "completion": 1.0,
                "finished": 0.0}
    if classes.is_single:
        att = attainment(scored, classes.default_slo)
        per_class = None
    else:
        att, per_class = attainment_summary(scored, classes)
        # the min ranges over classes that SUBMITTED post-warmup traffic:
        # a class that drew no arrivals is vacuously fine (matching the
        # single-class "not submitted" branch above), not starved — else
        # low-rate goodput probes would report 0.0 on empty classes.  A
        # class with submitted-but-unfinished requests still scores 0.0.
        known = set(classes.names)
        active = {r.slo_class if r.slo_class in known else classes.default
                  for r in submitted}
        att_min = min(per_class[c] for c in active)
    completion = len(scored) / max(1, len(submitted))
    out = {"rate": rate, "attainment": att, "completion": completion,
           "finished": float(len(scored))}
    if per_class is not None:
        out["attainment_by_class"] = per_class
        out["attainment_min"] = att_min
    if phases:
        edges = (phase_edges(duration, warmup, phases)
                 if isinstance(phases, int) else [float(b) for b in phases])
        met = {id(r) for r in scored
               if request_meets_slo(r, classes.for_request(r))}
        by_phase = []
        for lo, hi in zip(edges, edges[1:]):
            sub = [r for r in submitted if lo <= r.arrival_time < hi]
            # an empty phase is vacuously fine (same contract as the
            # zero-submission branch above)
            by_phase.append(
                sum(1 for r in sub if id(r) in met) / len(sub)
                if sub else 1.0)
        out["attainment_by_phase"] = by_phase
        out["attainment_phase_min"] = min(by_phase) if by_phase else 1.0
    if hasattr(system, "pool_of_rid"):
        # fleet cell (repro_torch.fleet): score each pool over the requests
        # routed to it — submitted-but-unfinished requests count against
        # their pool, and the min ranges over pools that received
        # post-warmup traffic (an idle pool is vacuously fine, matching
        # the class-grid contract above)
        met = {id(r) for r in scored
               if request_meets_slo(r, classes.for_request(r))}
        by_pool: Dict[str, float] = {}
        active_pools = []
        for k, name in enumerate(system.pool_names):
            sub = [r for r in submitted
                   if system.pool_of_rid.get(r.rid) == k]
            by_pool[name] = (sum(1 for r in sub if id(r) in met) /
                             len(sub)) if sub else 1.0
            if sub:
                active_pools.append(name)
        out["attainment_by_pool"] = by_pool
        out["attainment_pool_min"] = (
            min(by_pool[n] for n in active_pools) if active_pools else 1.0)
        out["fleet"] = system.fleet_summary()
    if harness is not None:
        out["timeline"] = harness.timeline.summary()
    if injector is not None:
        out["faults"] = injector.summary()
    out.update(percentile_latencies(scored))
    if tracer is not None:
        # JSON-safe digest only: callers that want the events pass their
        # own Tracer (trace=<Tracer>) and keep the reference
        out["trace"] = {"events": len(tracer.events)}
        if trace_path is not None:
            from repro_torch.obs.export import write_jsonl
            write_jsonl(tracer, trace_path)
            out["trace"]["path"] = str(trace_path)
    return out


def goodput(system_factory, workload, slo, target_attainment: float,
            lo: float = 0.05, hi: float = 64.0, tol: float = 0.10,
            duration: float = 240.0, warmup: float = None,
            seed: int = 0) -> Dict[str, float]:
    """Binary search for the highest rate with attainment >= target
    (the paper's Fig. 8 metric, per traffic shape).
    Unfinished requests count against attainment via the completion factor.
    ``workload`` is a ``WorkloadProfile`` or a ``(rate, seed) -> scenario``
    factory (a fixed scenario has no rate knob to search over).

    Under a heterogeneous ``SLOClassSet`` the search criterion is the
    MIN-over-classes attainment: every class must meet the target at the
    reported rate, so one starved tenant caps the frontier.
    Returns {goodput, attainment_at_goodput, probes, ...}."""
    if not isinstance(workload, WorkloadProfile) and \
            hasattr(workload, "generate"):
        raise TypeError(
            "goodput() searches over request rates, but a fixed scenario "
            "object ignores the probed rate; pass a WorkloadProfile or a "
            "(rate, seed) -> scenario factory instead")
    probes = 0

    def ok(rate: float) -> bool:
        nonlocal probes
        probes += 1
        m = run_once(system_factory, workload, rate, slo,
                     duration=duration, warmup=warmup, seed=seed)
        # multi-class rows carry attainment_min; single-class rows reduce
        # to the scalar attainment (bit-identical legacy criterion)
        score = m.get("attainment_min", m["attainment"])
        return score * min(1.0, m["completion"] + 1e-9) \
            >= target_attainment

    if not ok(lo):
        return {"goodput": 0.0, "target": target_attainment,
                "probes": float(probes)}
    # geometric bisection between the bracketing rates
    while hi / lo > 1 + tol:
        mid = (lo * hi) ** 0.5
        if ok(mid):
            lo = mid
        else:
            hi = mid
    final = run_once(system_factory, workload, lo, slo,
                     duration=duration, warmup=warmup, seed=seed + 1)
    out = {"goodput": lo, "target": target_attainment,
           "probes": float(probes),
           "attainment": final["attainment"], **{
               k: v for k, v in final.items()
               if k.startswith(("ttft", "tpot"))}}
    for k in ("attainment_by_class", "attainment_min"):
        if k in final:
            out[k] = final[k]
    return out
