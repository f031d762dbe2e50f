"""Unified experiment runner: strategy x scenario x rate sweeps.

``ExperimentRunner`` fans the cross product of serving strategies
(EcoServe/PaDG, vLLM-NoDG, Sarathi-NoDG, DistServe-FuDG, MoonCake-FuDG),
arrival scenarios (``repro_torch.simulator.scenarios``), and request rates over
a ``multiprocessing`` pool.  Every cell derives its own RNG seed from
(base_seed, strategy, scenario, rate) via CRC32 — not Python's ``hash``,
which is salted per process — so the result grid is bit-exactly
reproducible regardless of worker count or scheduling order.  The grid
feeds ``benchmarks/bench_scenarios.py`` and the golden regression test in
``tests/test_scenarios.py``.

Two per-cell modes:

* ``mode="fixed"`` (default) — one simulation per (strategy, scenario,
  rate) cell, reporting SLO attainment at that fixed rate.
* ``mode="goodput"`` — one cell per (strategy, scenario): the worker
  binary-searches the highest request rate whose attainment still meets
  ``target_attainment`` (DistServe-style goodput search, the paper's
  Fig. 8 frontier per traffic shape).  Practical only because the
  simulator hot path is fast enough to run the ~10 probe simulations a
  search needs inside a single worker.

Strategies are ``StrategySpec`` names resolved by ``repro_torch.baselines``:
registered specs (``"vllm"``, ``"ecoserve++"``) or ``"base+policy"``
grammar compositions (``"vllm+priority"``, ``"mooncake+spf"``) — grid
cells name policy bundles directly, and every result row carries the
resolved ``describe()`` bundle under ``"system"`` (also in the streamed
JSONL), so rows are self-documenting.

Three more grid axes (all seed-disambiguated through ``cell_seed``'s
``extra`` component, so legacy single-axis grids keep their historical
seeds):

* ``tenants=("alpaca", "longbench")`` — every cell becomes a
  multi-tenant ``MixedScenario`` with one stream per listed Table 4
  workload, tagged with that workload name as its ``slo_class`` and
  scored against its own SLO; rows carry ``attainment_by_class`` and
  ``attainment_min``, and goodput mode bisects on the min-over-classes
  attainment (one starved tenant caps the frontier).  Entries may pin a
  rate share and a per-tenant arrival shape:
  ``tenants=(("alpaca", 0.7, "bursty"), ("longbench", 0.3, "diurnal"))``
  (plain-name tuples keep their PR 3 seeds).
* ``n_instances=(1, 2, 4)`` — the instance count as a grid axis (Fig. 9
  static scaling, folded from the old standalone bench loop).
* ``tp=((4, 1), (2, 2))`` — the parallelism degree as a grid axis
  (ints or (tp, pp) pairs); with ``slo_override=(ttft, tpot)`` this
  folds the Fig. 11 PP-compatibility bench into the runner.
* ``autoscale=(None, "band", "threshold")`` — the closed-loop
  autoscaling controller (``repro_torch.control``) as a grid axis; ``None``
  cells run static.  Deliberately seed-neutral: every controller variant
  replays the identical arrival sequence, so attainment deltas isolate
  the controller.  ``phases=K`` adds per-phase attainment columns
  (fixed-rate mode only; goodput mode rejects ``autoscale``).
  Scenario kinds ``"trace:azure"`` / ``"trace:burstgpt"`` replay the
  converted real-trace excerpts (``repro_torch.traces``) rate-normalized to
  the cell rate.
* ``fleet="chat=llama-30b/ecoserve/4,...;budget=24"`` — multi-model
  fleet serving (``repro_torch.fleet``): every cell builds N model pools under
  one GPU budget, the ``strategies`` slot names routing policies, and
  ``autoscale="rebalance"`` installs the budget-constrained rebalancer.
  Seed-neutral like ``autoscale`` (constant "fleet" seed label), so all
  router/rebalance variants replay identical arrivals; rows carry
  ``attainment_by_pool`` / ``attainment_pool_min`` and a ``fleet``
  routing/budget digest.

Cells run through ``imap_unordered`` with per-cell error capture: a
crashing cell yields a row carrying its spec and the error string instead
of poisoning the whole ``pool.map``.  Pass ``stream_path`` to append one
JSONL row per *finished* cell so long sweeps survive interruption.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import traceback
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs import get_config
from repro_torch.core.slo import DATASET_SLOS, SLO, SLOClassSet
from repro_torch.simulator.cost_model import (GPU_A800, GPU_L20, TPU_V5E_SIM,
                                        InstanceCostModel)
from repro_torch.simulator.metrics import goodput, run_once
from repro_torch.simulator.scenarios import (SCENARIO_KINDS, make_mixed_scenario,
                                       make_scenario)

HARDWARE = {"L20": GPU_L20, "A800": GPU_A800, "tpu-v5e": TPU_V5E_SIM}

# metrics kept in the persisted grid (attainment + tail latency summary;
# the *_by_class / *_min keys appear only on multi-tenant cells, so
# single-class golden grids keep their legacy rows)
SUMMARY_KEYS = ("attainment", "attainment_min", "attainment_by_class",
                "attainment_by_phase", "attainment_phase_min",
                "attainment_by_pool", "attainment_pool_min", "fleet",
                "timeline", "faults", "completion", "finished",
                "ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99")
GOODPUT_SUMMARY_KEYS = ("goodput", "target", "probes", "attainment",
                        "attainment_min", "attainment_by_class",
                        "ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99")

# runner fields that parameterize the goodput search; excluded from the
# persisted meta in fixed mode so pre-existing golden grids stay valid
_GOODPUT_FIELDS = ("mode", "target_attainment", "goodput_lo", "goodput_hi",
                   "goodput_tol")


def cell_seed(base_seed: int, strategy: str, scenario: str,
              rate: float, extra: str = "") -> int:
    """Deterministic per-cell seed, stable across processes and runs.
    ``extra`` disambiguates additional grid axes (tenant mixes, swept
    instance counts); an empty ``extra`` reproduces the historical seed
    for every pre-existing golden cell."""
    key = f"{strategy}|{scenario}|{rate:.6f}".encode()
    if extra:
        key += f"|{extra}".encode()
    return (zlib.crc32(key) ^ (base_seed * 2654435761)) & 0x7FFFFFFF


def tenant_names(tenants: Sequence) -> List[str]:
    """Workload names out of a tenant axis spec (entries are names or
    ``(name, share[, shape])`` tuples/lists)."""
    return [e if isinstance(e, str) else e[0] for e in tenants]


def _run_cell(spec: Dict) -> Dict:
    """Worker entry point: one (strategy, scenario, rate) simulation, or
    one per-(strategy, scenario) goodput search when spec["mode"] is
    "goodput".  Every row carries the strategy's ``describe()`` bundle
    under ``"system"`` so results are self-documenting."""
    # imported here (not module level): repro_torch.baselines pulls in the
    # system classes, which import repro_torch.simulator — a cycle at load time
    from repro_torch.baselines import describe_strategy, make_system
    tenants = spec.get("tenants")
    if tenants:
        # one SLO class per tenant workload (Table 4 budgets); requests
        # are tagged by MixedScenario and scored per class
        slo = SLOClassSet.make(
            {w: DATASET_SLOS[w] for w in tenant_names(tenants)})
    elif spec.get("slo_override"):
        # pinned scalar budgets (the PP-compatibility sweep relaxes TPOT
        # away from any Table 4 workload)
        slo = SLO(ttft=spec["slo_override"][0], tpot=spec["slo_override"][1])
    else:
        slo = DATASET_SLOS[spec["workload"]]

    if spec.get("fleet"):
        # fleet cell: the strategy slot names a ROUTER; the pools carry
        # their own models, strategies, and cost models from the spec
        # string, so the cell-level model/n_instances fields don't apply
        from repro_torch.fleet import FleetSystem

        def factory():
            return FleetSystem(spec["fleet"], slo, hw=spec["hw"],
                               tp=spec["tp"], pp=spec["pp"],
                               router=spec["strategy"])

        describe = factory().describe()
    else:
        cost = InstanceCostModel(cfg=get_config(spec["model"]),
                                 hw=HARDWARE[spec["hw"]],
                                 tp=spec["tp"], pp=spec["pp"])
        if spec.get("calibration"):      # None = analytic (roofline) cell
            # measured-constants executor: timing from the saved
            # CalibrationReport fit, capacity/transfer geometry inherited
            # from the analytic model it replaces (import is numpy-only)
            from repro_torch.serving.calibration import load_fitted_executor
            cost = load_fitted_executor(spec["calibration"], like=cost)
        describe = describe_strategy(spec["strategy"])

        def factory():
            return make_system(spec["strategy"], cost, spec["n_instances"],
                               slo)

    if spec.get("mode") == "goodput":
        # rate knob stays live inside the search: each probe regenerates
        # the scenario at the probed rate under the cell's fixed seed
        if tenants:
            scen_factory = functools.partial(
                make_mixed_scenario, spec["scenario"], tenants)
        else:
            scen_factory = functools.partial(
                make_scenario, spec["scenario"], spec["workload"])
        g = goodput(factory, scen_factory, slo,
                    target_attainment=spec["target_attainment"],
                    lo=spec["goodput_lo"], hi=spec["goodput_hi"],
                    tol=spec["goodput_tol"], duration=spec["duration"],
                    warmup=spec["warmup"], seed=spec["seed"])
        summary = {k: g[k] for k in GOODPUT_SUMMARY_KEYS if k in g}
        return {**spec, "metrics": summary, "system": describe}

    if tenants:
        scenario = make_mixed_scenario(spec["scenario"], tenants,
                                       spec["rate"], seed=spec["seed"])
    else:
        scenario = make_scenario(spec["scenario"], spec["workload"],
                                 spec["rate"], seed=spec["seed"])
    run_kw = {}
    if spec.get("autoscale"):        # None = static cell, no control loop
        run_kw["control"] = spec["autoscale"]
    if spec.get("phases"):
        run_kw["phases"] = spec["phases"]
    if spec.get("faults"):           # None = fault-free cell
        run_kw["faults"] = spec["faults"]
    if spec.get("trace"):            # None = untraced cell (legacy)
        run_kw["trace"] = spec["trace"]
    metrics = run_once(factory, scenario, spec["rate"], slo,
                       duration=spec["duration"], warmup=spec["warmup"],
                       seed=spec["seed"], **run_kw)
    summary = {k: metrics[k] for k in SUMMARY_KEYS if k in metrics}
    return {**spec, "metrics": summary, "system": describe}


def _run_cell_safe(item: Tuple[int, Dict]) -> Tuple[int, Dict]:
    """imap_unordered entry: never raises — a failed cell reports its spec
    and the error so the rest of the grid survives."""
    idx, spec = item
    try:
        return idx, _run_cell(spec)
    except Exception as exc:  # noqa: BLE001 — deliberate catch-all
        return idx, {**spec,
                     "error": f"{type(exc).__name__}: {exc}",
                     "traceback": traceback.format_exc(limit=8)}


@dataclasses.dataclass
class ExperimentRunner:
    """Sweeps strategies x scenarios x rates into a tidy result grid."""

    strategies: Optional[Sequence[str]] = None   # None: every registered one
    scenarios: Sequence[str] = tuple(
        k for k in SCENARIO_KINDS if k != "ramp")
    rates: Sequence[float] = (8.0,)
    model: str = "llama-30b"
    hw: str = "L20"
    # a bare int (legacy) or a sequence: a sequence makes the parallelism
    # degree a grid axis (Fig. 11 PP compatibility folded into the
    # runner).  Sequence entries are ints (``pp`` applies) or (tp, pp)
    # pairs for joint sweeps like ``tp=((4, 1), (2, 2))``.
    tp: Union[int, Sequence] = 4
    pp: int = 1
    # a bare int (legacy) or a sequence: a sequence makes the instance
    # count a grid axis (Fig. 9 static scaling folded into the runner)
    n_instances: Union[int, Sequence[int]] = 8
    workload: str = "sharegpt"
    # multi-tenant mode: tenant workload names (Table 4); each cell runs a
    # MixedScenario with one tenant stream per entry, tagged with that
    # workload name as its slo_class, scored against DATASET_SLOS per
    # class.  Entries are names (equal share, the cell's scenario shape)
    # or (name, share[, shape]) tuples pinning that tenant's fraction of
    # the rate and optionally its own arrival shape, e.g.
    # ``tenants=(("alpaca", 0.7, "bursty"), ("longbench", 0.3, "diurnal"))``.
    # None = legacy single-class cells (``workload`` applies).
    tenants: Optional[Sequence] = None
    # pinned (ttft, tpot) overriding the workload's Table 4 budgets
    # (single-class only; the PP sweep relaxes TPOT past any workload's)
    slo_override: Optional[Sequence[float]] = None
    # autoscaling axis (closed-loop control plane, repro_torch.control): None =
    # every cell static (legacy); a controller spec string ("band",
    # "threshold", "band:max=8") or a sequence of them — None entries
    # mean "static baseline" — makes the controller a grid level.
    # Deliberately NOT folded into cell seeds: an autoscaled cell and its
    # static baseline replay the IDENTICAL arrival sequence, so their
    # attainment difference is the controller's doing alone.
    autoscale: Union[None, str, Sequence[Optional[str]]] = None
    # fault-injection axis (repro_torch.faults): None = every cell fault-free
    # (legacy); a fault-spec string ("crash:t=14", "spot:mtbf=20,notice=2"),
    # a named interruption trace ("itrace:gentle"), or a sequence of them
    # — None entries mean "fault-free baseline" — makes the fault schedule
    # a grid level.  Seed-neutral like ``autoscale``: a faulted cell and
    # its clean baseline replay the IDENTICAL arrival sequence, so the
    # attainment delta isolates the faults (the schedule itself derives
    # its own RNG stream from (spec, cell seed)).
    faults: Union[None, str, Sequence[Optional[str]]] = None
    # calibrated-executor axis (sim-to-real write-back): None = every
    # cell analytic (legacy); a path to a saved CalibrationReport JSON
    # (benchmarks/bench_calibration.py) — or a sequence of paths/None —
    # makes the cost model a grid level: None cells schedule with the
    # roofline model, path cells with a FittedExecutor carrying the
    # report's measured constants.  Seed-neutral like ``autoscale``: a
    # calibrated cell and its analytic baseline replay the IDENTICAL
    # arrival sequence, so the metric delta isolates the cost model.
    calibration: Union[None, str, Sequence[Optional[str]]] = None
    # multi-model fleet axis (repro_torch.fleet): None = every cell single-pool
    # (legacy); a fleet spec string "name=model/strategy/n,...;budget=G"
    # — or a sequence of spec strings — makes the fleet a grid level.
    # With a fleet, the ``strategies`` slot names ROUTERS ("pinned" /
    # "cheapest-feasible" / "quality-tiered"; default all three) and the
    # ``autoscale`` axis takes the "rebalance[:k=v,...]" spec.  Seed
    # discipline: cell seeds use the constant label "fleet" in the
    # strategy slot and exclude the fleet value itself, so every router x
    # fleet x autoscale variant replays the IDENTICAL arrival sequence —
    # routing and rebalancing deltas isolate the policy, not the draw.
    fleet: Union[None, str, Sequence[str]] = None
    # split the scored window into this many equal attainment phases
    # (rows gain attainment_by_phase / attainment_phase_min)
    phases: Optional[int] = None
    # flight-recorder capture (repro_torch.obs): None = untraced (legacy); a
    # directory path makes every cell write its event stream to
    # ``<dir>/cell<idx>.trace.jsonl``.  Seed-neutral BY CONSTRUCTION, not
    # just by seed bookkeeping: tracing is observation-only, so a traced
    # cell's metrics are bit-identical to the untraced cell's (the
    # property test pins this), and "trace" never enters SUMMARY_KEYS so
    # golden rows can't see it.
    trace: Optional[str] = None
    duration: float = 60.0
    warmup: Optional[float] = None
    base_seed: int = 0
    n_workers: Optional[int] = None   # None: one per core, capped by cells
    # ---- goodput mode (Fig. 8 frontier) ------------------------------- #
    mode: str = "fixed"               # "fixed" | "goodput"
    target_attainment: float = 0.9
    goodput_lo: float = 0.25          # search bracket (req/s)
    goodput_hi: float = 32.0
    goodput_tol: float = 0.10         # relative rate tolerance
    # append one JSONL row per finished cell (crash/interrupt recovery)
    stream_path: Optional[str] = None

    def __post_init__(self):
        if self.strategies is None:
            if self.fleet is not None:
                # with a fleet the strategy slot names routers
                from repro_torch.fleet import ROUTERS
                self.strategies = tuple(ROUTERS)
            else:
                from repro_torch.baselines import STRATEGIES
                self.strategies = STRATEGIES
        if self.fleet is not None:
            if self.mode == "goodput":
                raise ValueError("fleet cells are fixed-rate only: the "
                                 "rebalancer's capacity moves and the "
                                 "goodput search's rate knob would chase "
                                 "each other")
            if self.calibration is not None:
                raise ValueError("calibration is single-pool only; fleet "
                                 "pools own their per-model cost models")
            if self.slo_override is not None:
                raise ValueError("slo_override is single-pool only; fleet "
                                 "cells score against per-class Table 4 "
                                 "SLOs")
            if any(f is None for f in self._fleet_axis()):
                raise ValueError("fleet axis entries must be fleet spec "
                                 "strings: a None (no-fleet) entry would "
                                 "reinterpret the strategy slot mid-grid")
        if self.mode not in ("fixed", "goodput"):
            raise ValueError(f"unknown mode {self.mode!r}; "
                             "expected 'fixed' or 'goodput'")
        if self.tenants is not None and len(self.tenants) == 0:
            raise ValueError("tenants must be None or a non-empty sequence")
        if self.tenants is not None and self.slo_override is not None:
            raise ValueError("slo_override is single-class only; tenant "
                             "cells score against per-class Table 4 SLOs")
        if self.autoscale is not None and self.mode == "goodput":
            raise ValueError("autoscale cells are fixed-rate only: the "
                             "goodput search's rate knob and the "
                             "controller's capacity knob would chase "
                             "each other")
        if self.faults is not None and self.mode == "goodput":
            raise ValueError("fault cells are fixed-rate only: the "
                             "schedule is laid out over the cell's fixed "
                             "duration, and a fault mid-bisection would "
                             "make the frontier measure luck, not "
                             "capacity")
        if self.calibration is not None and self.mode == "goodput":
            raise ValueError("calibration cells are fixed-rate only for "
                             "now: a frontier over mixed cost models "
                             "would hide which model moved it")
        if self.trace is not None and self.mode == "goodput":
            raise ValueError("trace capture is fixed-rate only: the "
                             "goodput search runs ~10 probe simulations "
                             "per cell and each would overwrite the "
                             "cell's trace file")

    # ---- grid axes ---------------------------------------------------- #
    def _instance_counts(self) -> Tuple[int, ...]:
        if isinstance(self.n_instances, int):
            return (self.n_instances,)
        return tuple(self.n_instances)

    def _tp_pairs(self) -> Tuple[Tuple[int, int], ...]:
        if isinstance(self.tp, int):
            return ((self.tp, self.pp),)
        return tuple((t, self.pp) if isinstance(t, int)
                     else (int(t[0]), int(t[1])) for t in self.tp)

    def _autoscale_axis(self) -> Tuple[Optional[str], ...]:
        if self.autoscale is None:
            return (None,)
        if isinstance(self.autoscale, str):
            return (self.autoscale,)
        return tuple(self.autoscale)

    def _faults_axis(self) -> Tuple[Optional[str], ...]:
        if self.faults is None:
            return (None,)
        if isinstance(self.faults, str):
            return (self.faults,)
        return tuple(self.faults)

    def _calibration_axis(self) -> Tuple[Optional[str], ...]:
        if self.calibration is None:
            return (None,)
        if isinstance(self.calibration, str):
            return (self.calibration,)
        return tuple(self.calibration)

    def _fleet_axis(self) -> Tuple[Optional[str], ...]:
        if self.fleet is None:
            return (None,)
        if isinstance(self.fleet, str):
            return (self.fleet,)
        return tuple(self.fleet)

    def _norm_tenants(self) -> Optional[List]:
        """JSON-able tenant entries for cell specs: names stay strings
        (legacy golden cells keep their exact spec), rich entries become
        [name, share, shape] lists — widened to [name, share, shape,
        model] ONLY for entries that carry a model tag, so pre-fleet
        golden specs stay byte-identical."""
        if self.tenants is None:
            return None
        out: List = []
        for e in self.tenants:
            if isinstance(e, str):
                out.append(e)
            else:
                width = 4 if len(e) > 3 else 3
                seq = list(e) + [None] * (width - len(e))
                row = [seq[0],
                       None if seq[1] is None else float(seq[1]),
                       seq[2]]
                if width == 4:
                    row.append(seq[3])
                out.append(row)
        return out

    def _seed_extra(self, n: int, tp_pair: Tuple[int, int]) -> str:
        """Extra seed-key components for the new grid axes.  Empty for a
        legacy single-class, single-count, single-tp grid — those cells
        keep their historical seeds and golden fixtures.  Plain-name
        tenant tuples keep the PR 3 encoding (and therefore seeds);
        share/shape-qualified entries encode all three fields."""
        parts = []
        if self.tenants:
            enc = []
            for e in self.tenants:
                if isinstance(e, str):
                    enc.append(e)
                else:
                    seq = tuple(e)
                    share = "" if len(seq) < 2 or seq[1] is None \
                        else f"{float(seq[1]):g}"
                    shape = seq[2] if len(seq) > 2 and seq[2] else ""
                    key = f"{seq[0]}:{share}:{shape}"
                    if len(seq) > 3 and seq[3]:
                        # model tag appended only for 4-field entries:
                        # 3-field entries keep their pre-fleet seeds
                        key += f":{seq[3]}"
                    enc.append(key)
            parts.append("tenants=" + "+".join(enc))
        if len(self._instance_counts()) > 1:
            parts.append(f"n={n}")
        if len(self._tp_pairs()) > 1:
            parts.append(f"tp={tp_pair[0]}x{tp_pair[1]}")
        return "|".join(parts)

    def cells(self) -> List[Dict]:
        common = dict(model=self.model, hw=self.hw,
                      workload=self.workload,
                      duration=self.duration, warmup=self.warmup)
        tenants = self._norm_tenants()
        if tenants:
            common["tenants"] = tenants
        if self.slo_override is not None:
            common["slo_override"] = [float(x) for x in self.slo_override]
        if self.phases is not None:
            common["phases"] = int(self.phases)
        out = []
        if self.mode == "goodput":
            common.update(mode="goodput",
                          target_attainment=self.target_attainment,
                          goodput_lo=self.goodput_lo,
                          goodput_hi=self.goodput_hi,
                          goodput_tol=self.goodput_tol)
            for strat in self.strategies:
                for scen in self.scenarios:
                    for n in self._instance_counts():
                        for t, p in self._tp_pairs():
                            # rate 0.0 = the search's seed sentinel: one
                            # seed per (strategy, scenario[, axes]),
                            # shared by every probe
                            out.append({**common, "strategy": strat,
                                        "scenario": scen, "n_instances": n,
                                        "tp": t, "pp": p,
                                        "seed": cell_seed(
                                            self.base_seed, strat, scen,
                                            0.0,
                                            extra=self._seed_extra(
                                                n, (t, p)))})
            return out
        for strat in self.strategies:
            for scen in self.scenarios:
                for rate in self.rates:
                    for n in self._instance_counts():
                        for t, p in self._tp_pairs():
                            for ctrl in self._autoscale_axis():
                              for fv in self._faults_axis():
                                for cal in self._calibration_axis():
                                  for fl in self._fleet_axis():
                                    # fleet cells seed under the constant
                                    # label "fleet": every router variant
                                    # replays identical arrivals, so
                                    # routing deltas isolate the policy
                                    seed_label = ("fleet"
                                                  if self.fleet is not None
                                                  else strat)
                                    cell = {**common, "strategy": strat,
                                            "scenario": scen, "rate": rate,
                                            "n_instances": n,
                                            "tp": t, "pp": p,
                                            "seed": cell_seed(
                                                self.base_seed, seed_label,
                                                scen, rate,
                                                extra=self._seed_extra(
                                                    n, (t, p)))}
                                    if self.autoscale is not None:
                                        # same seed across controller
                                        # values: static vs autoscaled
                                        # cells replay identical arrivals
                                        # by design
                                        cell["autoscale"] = ctrl
                                    if self.faults is not None:
                                        # ditto: faulted vs clean cells
                                        # share arrivals by design
                                        cell["faults"] = fv
                                    if self.calibration is not None:
                                        # ditto: calibrated vs analytic
                                        # cells share arrivals by design
                                        cell["calibration"] = cal
                                    if self.fleet is not None:
                                        # ditto: every fleet spec variant
                                        # shares arrivals by design
                                        cell["fleet"] = fl
                                    out.append(cell)
        if self.trace is not None:
            import os
            for i, cell in enumerate(out):
                cell["trace"] = os.path.join(
                    self.trace, f"cell{i:04d}.trace.jsonl")
        return out

    def run(self) -> Dict:
        specs = self.cells()
        workers = self.n_workers
        if workers is None:
            workers = min(len(specs), multiprocessing.cpu_count())
        rows: List[Optional[Dict]] = [None] * len(specs)
        stream = open(self.stream_path, "a") if self.stream_path else None
        try:
            if workers > 1:
                # spawn, not fork: the parent may have imported jax
                # (pytest, notebooks), and forking a multithreaded process
                # can deadlock
                ctx = multiprocessing.get_context("spawn")
                with ctx.Pool(workers) as pool:
                    for idx, row in pool.imap_unordered(
                            _run_cell_safe, list(enumerate(specs))):
                        rows[idx] = row
                        self._stream_row(stream, idx, row)
            else:
                for idx, spec in enumerate(specs):
                    _, row = _run_cell_safe((idx, spec))
                    rows[idx] = row
                    self._stream_row(stream, idx, row)
        finally:
            if stream is not None:
                stream.close()
        meta = dataclasses.asdict(self)
        meta.pop("n_workers")        # parallelism does not affect results
        meta.pop("stream_path")      # neither does streaming
        if self.mode == "fixed":     # keep legacy golden meta stable
            for k in _GOODPUT_FIELDS:
                meta.pop(k)
        if self.tenants is None:     # legacy single-class grids keep the
            meta.pop("tenants")      # pre-multi-tenant meta shape
        else:
            meta["tenants"] = self._norm_tenants()
        if self.slo_override is None:   # ditto for the pinned-SLO knob
            meta.pop("slo_override")
        else:
            meta["slo_override"] = [float(x) for x in self.slo_override]
        if self.autoscale is None:      # and for the autoscale/phase axes
            meta.pop("autoscale")
        else:
            meta["autoscale"] = list(self._autoscale_axis())
        if self.faults is None:         # and for the fault axis
            meta.pop("faults")
        else:
            meta["faults"] = list(self._faults_axis())
        if self.calibration is None:    # and for the calibration axis
            meta.pop("calibration")
        else:
            meta["calibration"] = list(self._calibration_axis())
        if self.fleet is None:          # and for the fleet axis
            meta.pop("fleet")
        else:
            meta["fleet"] = list(self._fleet_axis())
        if self.trace is None:          # and for the trace capture axis
            meta.pop("trace")
        if self.phases is None:
            meta.pop("phases")
        if not isinstance(self.n_instances, int):
            meta["n_instances"] = list(self.n_instances)
        if not isinstance(self.tp, int):
            meta["tp"] = [list(p) for p in self._tp_pairs()]
        meta["strategies"] = list(self.strategies)
        meta["scenarios"] = list(self.scenarios)
        meta["rates"] = list(self.rates)
        results = {"meta": meta, "cells": rows}
        errors = [r for r in rows if r is not None and "error" in r]
        if errors:
            results["errors"] = [
                {k: v for k, v in r.items() if k != "traceback"}
                for r in errors]
        return results

    @staticmethod
    def _stream_row(stream, idx: int, row: Dict) -> None:
        if stream is None:
            return
        stream.write(json.dumps({"cell_index": idx, **row},
                                sort_keys=True) + "\n")
        stream.flush()

    # ------------------------------------------------------------------ #
    @staticmethod
    def grid(results: Dict) -> Dict[str, Dict[str, Dict[float, Dict]]]:
        """Pivot the flat cell list to [strategy][scenario][rate]
        (fixed mode) or [strategy][scenario] (goodput mode).  Swept axes
        insert their own levels after [scenario] so cells can't overwrite
        each other: a ``tp`` sweep keys ``"tp{T}pp{P}"``, an
        ``n_instances`` sweep keys the count, an ``autoscale`` sweep keys
        the controller spec (``"static"`` for None), a ``faults`` sweep
        keys the fault spec (``"none"`` for None), a ``calibration``
        sweep keys the report path (``"analytic"`` for None), and a
        ``fleet`` sweep keys the fleet spec string, in that order."""
        cells = results["cells"]
        multi_n = len({c.get("n_instances") for c in cells}) > 1
        multi_tp = len({(c.get("tp"), c.get("pp")) for c in cells}) > 1
        multi_as = len({c.get("autoscale") for c in cells}) > 1
        multi_f = len({c.get("faults") for c in cells}) > 1
        multi_cal = len({c.get("calibration") for c in cells}) > 1
        multi_fl = len({c.get("fleet") for c in cells}) > 1
        out: Dict[str, Dict[str, Dict]] = {}
        for cell in cells:
            leaf = cell.get("metrics", cell)
            keys: List = [cell["scenario"]]
            if multi_tp:
                keys.append(f"tp{cell['tp']}pp{cell['pp']}")
            if multi_n:
                keys.append(cell["n_instances"])
            if multi_as:
                keys.append(cell.get("autoscale") or "static")
            if multi_f:
                keys.append(cell.get("faults") or "none")
            if multi_cal:
                keys.append(cell.get("calibration") or "analytic")
            if multi_fl:
                keys.append(cell.get("fleet") or "none")
            if cell.get("mode") != "goodput":
                keys.append(cell["rate"])
            node = out.setdefault(cell["strategy"], {})
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf
        return out

    @staticmethod
    def save(results: Dict, path) -> None:
        with open(path, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
            f.write("\n")

    @staticmethod
    def load(path) -> Dict:
        with open(path) as f:
            return json.load(f)


# --------------------------------------------------------------------- #
# The canonical regression grid: small enough to run in CI, wide enough
# to pin every strategy x scenario pair.  bench_scenarios --write-golden
# regenerates tests/golden/scenario_grid.json from exactly this spec.
# --------------------------------------------------------------------- #

def regression_runner(n_workers: Optional[int] = None) -> ExperimentRunner:
    return ExperimentRunner(
        strategies=("ecoserve", "vllm", "sarathi", "distserve", "mooncake"),
        scenarios=("poisson", "bursty", "diurnal", "replay"),
        rates=(6.0,),
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=4,
        workload="sharegpt", duration=20.0, warmup=3.0,
        base_seed=42, n_workers=n_workers)


def goodput_runner(n_workers: Optional[int] = None) -> ExperimentRunner:
    """The canonical goodput-frontier grid (Fig. 8 per traffic shape),
    sized for CI; pinned by tests/golden/goodput_frontier.json.  The
    duration/lo pairing keeps >= ~24 scored requests per probe so a
    single end-of-window straggler can't sink the completion factor.
    ``vllm+priority`` (a composed ``StrategySpec``) rides along so the
    policy-grammar construction path is exercised by the frontier too.
    The strategy rows cover all four paper baselines (sarathi/distserve
    joined in PR 5) and the shapes cover all four rate-parameterized
    arrival processes — per-cell CRC seeds mean the widened grid keeps
    every pre-existing cell's metrics bit-exact.

    The ROADMAP composition sweep rides the same frontier:
    ``distserve+priority`` (EDF queue + backpressure admission on FuDG)
    and ``ecoserve+spf`` (shortest-prompt-first on PaDG) probe whether
    either composed policy Pareto-dominates its base across the shapes
    (notes in benchmarks/README.md)."""
    return ExperimentRunner(
        strategies=("ecoserve", "vllm", "sarathi", "distserve",
                    "mooncake", "vllm+priority",
                    "distserve+priority", "ecoserve+spf"),
        scenarios=("poisson", "bursty", "diurnal", "ramp"),
        mode="goodput", target_attainment=0.9,
        goodput_lo=1.0, goodput_hi=24.0, goodput_tol=0.35,
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=4,
        workload="sharegpt", duration=24.0, warmup=3.0,
        base_seed=42, n_workers=n_workers)


def tenant_runner(n_workers: Optional[int] = None) -> ExperimentRunner:
    """The canonical multi-tenant regression grid: two SLO classes with a
    15x TTFT spread (alpaca 1.0 s vs longbench 15 s, Table 4) mixed into
    every cell, across two traffic shapes; pinned bit-exactly by
    tests/golden/tenant_grid.json.  Every row carries the per-class
    attainment grid plus the min-over-classes scalar.  The SLO-aware
    NoDG compositions (``vllm+priority``, ``sarathi+priority``) run next
    to blind vLLM so the grid compares EcoServe against a priority-queue
    NoDG, not just a blind one (ROADMAP item 1)."""
    return ExperimentRunner(
        strategies=("ecoserve", "vllm", "mooncake",
                    "vllm+priority", "sarathi+priority"),
        scenarios=("poisson", "bursty"),
        rates=(6.0,),
        tenants=("alpaca", "longbench"),
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=4,
        duration=20.0, warmup=3.0,
        base_seed=42, n_workers=n_workers)


def dynamic_scaling_runner(n_workers: Optional[int] = None
                           ) -> ExperimentRunner:
    """The canonical closed-loop autoscaling grid (paper Fig. 10 under
    non-stationary traffic); pinned by tests/golden/dynamic_scaling.json.

    EcoServe under every load-shifting shape — MMPP bursty, diurnal,
    ramp, and the two converted real-trace excerpts (Azure LLM
    inference, BurstGPT; ``repro_torch.traces``) — each cell run three ways
    over the IDENTICAL arrival sequence (autoscale is seed-neutral):
    static 4-instance baseline (None), the closed-loop target-band
    controller, and the trace-oblivious threshold baseline for ablation.
    Rows carry per-phase attainment (6 phases) and the recorded scaling
    timeline, so the golden pins both the attainment dips/recoveries and
    the exact scale-decision sequence."""
    return ExperimentRunner(
        strategies=("ecoserve",),
        scenarios=("bursty", "diurnal", "ramp",
                   "trace:azure", "trace:burstgpt"),
        rates=(16.0,),
        autoscale=(None, "band", "threshold"),
        phases=6,
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=4,
        workload="sharegpt", duration=72.0, warmup=6.0,
        base_seed=42, n_workers=n_workers)


def fault_runner(n_workers: Optional[int] = None) -> ExperimentRunner:
    """The canonical fault-degradation grid: EcoServe vs both FuDG
    baselines under the "gentle" interruption trace (one crash at t=14,
    one spot preemption with a 2 s notice at t=26) next to their
    fault-free baselines, every system running the same migrate failure
    policy, with and without the closed-loop band controller; pinned by
    tests/golden/fault_scenarios.json.

    The claim the golden pins: temporal disaggregation degrades
    gracefully under instance loss — any EcoServe survivor still serves
    both phases, so preemption notices migrate decodes to peers and the
    control loop's repair path re-provisions the lost capacity — whereas
    FuDG's role-partitioned pools collapse when a fault lands on the
    scarce role (a dead lone prefill instance starves the whole pool,
    and KV caches in flight to a dead decoder are simply lost).
    Seed-neutrality of the faults axis means each strategy's faulted and
    clean cells replay the identical arrival sequence."""
    return ExperimentRunner(
        strategies=("ecoserve+migrate", "distserve+migrate",
                    "mooncake+migrate"),
        scenarios=("bursty",),
        rates=(8.0,),
        autoscale=(None, "band"),
        faults=(None, "itrace:gentle"),
        phases=6,
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=4,
        workload="sharegpt", duration=48.0, warmup=6.0,
        base_seed=42, n_workers=n_workers)


def interconnect_runner(n_workers: Optional[int] = None
                        ) -> ExperimentRunner:
    """The canonical interconnect-sensitivity grid: EcoServe, a NoDG
    baseline (vLLM), and both FuDG baselines swept over commodity-link
    degradation grades — from a clean fabric through a modestly
    oversubscribed one to a saturated lossy link; pinned by
    tests/golden/interconnect_sensitivity.json.

    The claim the golden pins (the paper's commodity-interconnect
    premise): FuDG moves every request's KV cache across the fabric
    between prefill and decode, so its goodput tracks link quality and
    collapses when bandwidth divides away and losses force
    retry/timeout churn — while EcoServe and NoDG keep all phases of a
    request on one instance, exchange only control-plane messages, and
    hold their clean-link attainment across every grade.  The fault
    axis is seed-neutral: each strategy's degraded cells replay the
    identical arrival sequence as its clean cell, so the attainment
    delta isolates the interconnect."""
    return ExperimentRunner(
        strategies=("ecoserve", "vllm", "distserve", "mooncake"),
        scenarios=("bursty",),
        rates=(4.0,),
        faults=(None,
                "netdelay:40",
                "netdegrade:2;netdelay:120",
                "netdegrade:8;netdelay:240;netloss:0.02",
                "netdegrade:48;netdelay:480;netloss:0.08"),
        phases=4,
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=4,
        workload="sharegpt", duration=48.0, warmup=6.0,
        base_seed=42, n_workers=n_workers)


def fleet_grid_runner(n_workers: Optional[int] = None) -> ExperimentRunner:
    """The canonical multi-model fleet grid (repro_torch.fleet); pinned
    bit-exactly by tests/golden/fleet_grid.json.

    Two model pools — a qwen1.5-32b "chat" pool and a llama-30b "code"
    pool, both EcoServe stacks — share a 24-GPU budget.  Two tenant
    streams with opposite mid-run mix shifts (``shift:4,1`` vs
    ``shift:1,4``, model-tagged) swap which pool carries the load
    halfway through, while every router x rebalance cell replays the
    IDENTICAL arrival sequence (fleet cells seed under the constant
    label "fleet").  The surging tenant (longbench) rides the SMALLER
    model, so quality-tiered routing may legally spill its breaching
    requests up-tier into the draining qwen pool — the grid separates
    what routing alone recovers from what capacity movement recovers.

    The claims the golden pins: the static partition strands capacity
    on the wrong side of the shift — its min-over-pools attainment
    collapses in the post-shift phases — while budget-constrained
    rebalancing moves instances from the draining pool to the filling
    one and holds ``attainment_pool_min`` STRICTLY above the static
    cell's, under every routing policy, without ever exceeding the
    budget or emptying a pool; and quality-tiered spillover lifts the
    static floor well above pinned's even before any capacity moves."""
    return ExperimentRunner(
        strategies=("pinned", "cheapest-feasible", "quality-tiered"),
        scenarios=("poisson",),
        rates=(6.0,),
        tenants=(("sharegpt", 0.5, "shift:4,1", "qwen1.5-32b"),
                 ("longbench", None, "shift:1,4", "llama-30b")),
        fleet="chat=qwen1.5-32b/ecoserve/4,code=llama-30b/ecoserve/2"
              ";budget=24",
        autoscale=(None, "rebalance"),
        phases=4,
        model="llama-30b", hw="L20", tp=4, pp=1,
        duration=48.0, warmup=6.0,
        base_seed=42, n_workers=n_workers)


def static_scaling_runner(n_workers: Optional[int] = None
                          ) -> ExperimentRunner:
    """Fig. 9 static scaling folded into the unified runner: the instance
    count is a grid axis (each count gets its own CRC-derived cell seed);
    pinned by tests/golden/static_scaling.json."""
    return ExperimentRunner(
        strategies=("ecoserve",), scenarios=("poisson",), rates=(6.0,),
        n_instances=(2, 4),
        model="llama-30b", hw="L20", tp=4, pp=1,
        workload="sharegpt", duration=20.0, warmup=3.0,
        base_seed=42, n_workers=n_workers)
