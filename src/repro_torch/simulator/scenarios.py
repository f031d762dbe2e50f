"""Composable trace-driven arrival scenarios.

The stationary-Poisson generator in ``workload.py`` exercises the paper's
goodput claim under exactly one traffic shape; DistServe and DynaServe
both evaluate under bursty and shifting load because disaggregation
trade-offs invert there.  A ``Scenario`` pairs an ``ArrivalProcess``
(stationary Poisson, MMPP-style bursty, diurnal sinusoid, linear ramp)
with a ``WorkloadProfile``'s length distributions; everything draws from
one ``np.random.default_rng`` stream so a (scenario, seed, duration)
triple is bit-exactly reproducible.

``MixedScenario`` composes N tenant streams — each an
``(arrival_process, profile, slo_class)`` triple — into one seeded,
merge-sorted arrival sequence for multi-tenant SLO experiments (see
``repro_torch.core.slo.SLOClassSet``).

Any generated workload can be frozen to a JSONL trace (one
``{"arrival_time", "prompt_len", "output_len"[, "slo_class"]}`` record
per line) with ``write_trace`` and replayed with ``TraceReplay`` — JSON
round-trips Python floats exactly, so replay reproduces the original
``Request`` stream bit-for-bit, ``slo_class`` tags included (untagged
legacy traces load as the default class).
"""
from __future__ import annotations

import dataclasses
import json
import math
import zlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.slo import DEFAULT_SLO_CLASS
from repro_torch.simulator.workload import (WORKLOADS, WorkloadProfile,
                                      poisson_arrival_times)

# --------------------------------------------------------------------- #
# arrival processes
# --------------------------------------------------------------------- #


def _thinned_times(rng: np.random.Generator, duration: float, peak: float,
                   rate_fn: Callable[[float], float]) -> np.ndarray:
    """Non-homogeneous Poisson process via Lewis-Shedler thinning."""
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= duration:
            break
        if rng.random() * peak <= rate_fn(t):
            out.append(t)
    return np.asarray(out, dtype=float)


class ArrivalProcess:
    """Seeded arrival-time sampler; ``rate`` is the time-averaged rate."""

    rate: float

    def sample(self, rng: np.random.Generator,
               duration: float) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Stationary Poisson at ``rate`` req/s (the seed repo's only shape)."""
    rate: float

    def sample(self, rng, duration):
        return poisson_arrival_times(rng, self.rate, duration)


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """MMPP-style bursty arrivals: exponential low/high phases alternate;
    the high-phase rate is ``burst`` x the low-phase rate, with phase
    durations chosen so the time-averaged rate stays ``rate``."""
    rate: float
    burst: float = 4.0        # high-phase rate multiplier over low phase
    phase_low: float = 12.0   # mean seconds spent in the low phase
    phase_high: float = 3.0   # mean seconds spent in the high phase

    def sample(self, rng, duration):
        r_low = self.rate * (self.phase_low + self.phase_high) / (
            self.phase_low + self.burst * self.phase_high)
        r_high = self.burst * r_low
        pieces: List[np.ndarray] = []
        t, high = 0.0, False
        while t < duration:
            mean_len = self.phase_high if high else self.phase_low
            length = rng.exponential(mean_len)
            end = min(t + length, duration)
            r = r_high if high else r_low
            n = rng.poisson(r * (end - t))
            if n:
                pieces.append(t + np.sort(rng.random(n)) * (end - t))
            t += length
            high = not high
        if not pieces:
            return np.empty(0)
        return np.concatenate(pieces)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal rate modulation: rate(t) = rate * (1 + A sin(2pi t/T))."""
    rate: float
    amplitude: float = 0.6    # in (0, 1]: peak = rate * (1 + amplitude)
    period: float = 120.0     # seconds per day-cycle (compressed)
    phase: float = 0.0

    def sample(self, rng, duration):
        peak = self.rate * (1.0 + self.amplitude)

        def rate_fn(t: float) -> float:
            return self.rate * (1.0 + self.amplitude * math.sin(
                2.0 * math.pi * (t + self.phase) / self.period))

        return _thinned_times(rng, duration, peak, rate_fn)


@dataclasses.dataclass(frozen=True)
class PhasedArrivals(ArrivalProcess):
    """Piecewise-stationary Poisson over equal windows: the horizon is
    split into ``len(weights)`` phases and phase k runs at
    ``rate * weights[k] / mean(weights)`` — so the time-averaged rate
    stays ``rate`` while the *mix* of a multi-tenant scenario shifts at
    phase boundaries (tenant A weighted ``(4, 1)`` against tenant B's
    ``(1, 4)`` trades places mid-run at the same total load).  Windows
    are sampled in order from the one RNG stream, exactly like the
    bursty process samples its phases."""
    rate: float
    weights: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if not self.weights or any(w < 0 for w in self.weights) \
                or sum(self.weights) <= 0:
            raise ValueError(f"shift weights must be non-negative with a "
                             f"positive sum, got {self.weights}")

    def sample(self, rng, duration):
        mean_w = sum(self.weights) / len(self.weights)
        k = len(self.weights)
        pieces: List[np.ndarray] = []
        for i, w in enumerate(self.weights):
            t0 = duration * i / k
            t1 = duration * (i + 1) / k
            n = rng.poisson(self.rate * (w / mean_w) * (t1 - t0))
            if n:
                pieces.append(t0 + np.sort(rng.random(n)) * (t1 - t0))
        if not pieces:
            return np.empty(0)
        return np.concatenate(pieces)


@dataclasses.dataclass(frozen=True)
class RampArrivals(ArrivalProcess):
    """Linear ramp from ``lo_frac*rate`` to ``hi_frac*rate`` over the
    horizon; defaults keep the time-averaged rate at ``rate``."""
    rate: float
    lo_frac: float = 0.25
    hi_frac: float = 1.75

    def sample(self, rng, duration):
        lo = self.lo_frac * self.rate
        hi = self.hi_frac * self.rate
        peak = max(lo, hi)

        def rate_fn(t: float) -> float:
            return lo + (hi - lo) * (t / duration)

        return _thinned_times(rng, duration, peak, rate_fn)


# --------------------------------------------------------------------- #
# scenarios
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A reproducible workload: arrival process x length distributions."""
    name: str
    profile: WorkloadProfile
    arrivals: ArrivalProcess
    seed: int = 0

    def generate(self, duration: float) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        times = self.arrivals.sample(rng, duration)
        n = len(times)
        ins = self.profile.input_dist.sample(rng, n)
        outs = self.profile.output_dist.sample(rng, n)
        return [
            Request(rid=i, arrival_time=float(times[i]),
                    prompt_len=int(ins[i]), output_len=int(outs[i]))
            for i in range(n)
        ]


# --------------------------------------------------------------------- #
# multi-tenant mixes
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant stream inside a ``MixedScenario``: its SLO-class tag,
    length distributions, and arrival process (carrying that tenant's
    share of the total rate).  ``model`` optionally tags every request
    of the stream with the model the tenant asks for (``repro_torch.fleet``
    routes on it); None keeps requests untagged."""
    slo_class: str
    profile: WorkloadProfile
    arrivals: ArrivalProcess
    model: Optional[str] = None


def _tenant_seed(seed: int, slo_class: str) -> int:
    """Per-tenant RNG seed derived from the tenant's IDENTITY (class tag),
    not its position — permuting the tenant tuple cannot move any
    tenant's stream.  Same CRC32 mixing discipline as the runner's
    ``cell_seed`` (never Python's salted ``hash``)."""
    return (zlib.crc32(slo_class.encode()) ^ (seed * 2654435761)) \
        & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class MixedScenario:
    """N tenant streams composed into one seeded arrival sequence.

    Each tenant draws from its own ``default_rng`` stream (seeded by
    tenant identity) exactly the way ``Scenario.generate`` draws — times,
    then input lengths, then output lengths — and the per-tenant
    sequences are merged into one time-sorted stream (stable: equal-time
    arrivals resolve by class name, then within-tenant order).  With a
    SINGLE tenant the stream seeds directly from ``seed``, so the request
    sequence is bit-identical to the equivalent ``Scenario`` (only the
    ``slo_class`` tag differs) — single-tenant sweeps reproduce the
    legacy golden grids exactly.
    """
    name: str
    tenants: Tuple[TenantSpec, ...]
    seed: int = 0

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("MixedScenario needs at least one tenant")
        names = [t.slo_class for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant slo_class in {names}")

    @property
    def rate(self) -> float:
        """Total time-averaged request rate across tenants."""
        return sum(t.arrivals.rate for t in self.tenants)

    @property
    def slo_classes(self) -> Tuple[str, ...]:
        return tuple(sorted(t.slo_class for t in self.tenants))

    def generate(self, duration: float) -> List[Request]:
        single = len(self.tenants) == 1
        merged: List[Tuple[float, int, int, str, Optional[str]]] = []
        for t in sorted(self.tenants, key=lambda t: t.slo_class):
            # per-tenant seeds key on the CLASS TAG only — adding or
            # changing another field (e.g. the fleet model tag) must not
            # move any tenant's draws
            tseed = self.seed if single else \
                _tenant_seed(self.seed, t.slo_class)
            rng = np.random.default_rng(tseed)
            times = t.arrivals.sample(rng, duration)
            n = len(times)
            ins = t.profile.input_dist.sample(rng, n)
            outs = t.profile.output_dist.sample(rng, n)
            merged.extend(
                (float(times[i]), int(ins[i]), int(outs[i]), t.slo_class,
                 t.model)
                for i in range(n))
        # stable sort of class-ordered streams == deterministic k-way
        # merge; rids are assigned in merged arrival order
        merged.sort(key=lambda rec: rec[0])
        return [
            Request(rid=i, arrival_time=at, prompt_len=p, output_len=o,
                    slo_class=c, model=m)
            for i, (at, p, o, c, m) in enumerate(merged)
        ]


def _norm_tenant_entry(entry) -> Tuple[str, Optional[float],
                                       Optional[str], Optional[str]]:
    """``"alpaca"`` | ``("alpaca", 0.7)`` | ``("alpaca", 0.7, "bursty")``
    | ``("alpaca", 0.7, "bursty", "llama-30b")``
    -> (workload name, share or None, arrival shape or None,
    model tag or None)."""
    if isinstance(entry, str):
        return entry, None, None, None
    seq = tuple(entry)
    if not seq or not isinstance(seq[0], str):
        raise TypeError(f"tenant entry {entry!r}: expected a workload "
                        "name or (name, share[, shape[, model]])")
    share = float(seq[1]) if len(seq) > 1 and seq[1] is not None else None
    shape = seq[2] if len(seq) > 2 and seq[2] else None
    model = seq[3] if len(seq) > 3 and seq[3] else None
    return seq[0], share, shape, model


def make_mixed_scenario(kind: str, tenant_workloads: Sequence,
                        rate: float, seed: int = 0,
                        shares: Optional[Sequence[float]] = None,
                        **kw) -> MixedScenario:
    """Compose one tenant per Table 4 workload name: each tenant's
    ``slo_class`` IS the workload name (so ``DATASET_SLOS`` supplies the
    per-class budgets) and its lengths come from that workload's profile.

    Entries are workload names (equal share of ``rate``, the cell's
    ``kind`` as arrival shape) or ``(name, share[, shape[, model]])``
    tuples pinning that tenant's fraction of the total rate and,
    optionally, its own arrival shape and fleet model tag — e.g. bursty
    alpaca over diurnal longbench:
    ``(("alpaca", 0.7, "bursty"), ("longbench", 0.3, "diurnal"))``, or a
    shifting two-model fleet mix:
    ``(("sharegpt", 0.5, "shift:4,1", "llama-30b"),
    ("longbench", None, "shift:1,4", "qwen1.5-32b"))``.
    Entries without an explicit share split the unclaimed remainder
    equally.  Per-tenant RNG streams are seeded by tenant *identity*
    either way, so adding a share/shape/model to one tenant never moves
    another tenant's draws."""
    entries = [_norm_tenant_entry(e) for e in tenant_workloads]
    if shares is not None:
        if len(shares) != len(entries):
            raise ValueError("one share per tenant workload")
        entries = [(n, float(s), sh, m)
                   for (n, _, sh, m), s in zip(entries, shares)]
    claimed = sum(s for _, s, _, _ in entries if s is not None)
    if claimed > 1.0 + 1e-9:
        raise ValueError(f"tenant shares sum to {claimed} > 1")
    unspec = sum(1 for _, s, _, _ in entries if s is None)
    if not unspec and abs(claimed - 1.0) > 1e-9:
        # all-explicit shares must cover the rate: a silent shortfall
        # would label result rows with an offered load nobody simulated
        raise ValueError(f"explicit tenant shares sum to {claimed}, "
                         "not 1; leave one share None to absorb the "
                         "remainder")
    default_share = (1.0 - claimed) / unspec if unspec else 0.0
    tenants = []
    for name, share, shape, model in entries:
        share = default_share if share is None else share
        scen = make_scenario(shape or kind, name, rate * share,
                             seed=seed, **kw)
        if not isinstance(scen, Scenario):
            raise TypeError(f"kind {shape or kind!r} does not parameterize "
                            "by rate and cannot form a tenant stream")
        tenants.append(TenantSpec(slo_class=name, profile=scen.profile,
                                  arrivals=scen.arrivals, model=model))
    names = [n for n, _, _, _ in entries]
    return MixedScenario(name=f"{kind}+{'+'.join(names)}",
                         tenants=tuple(tenants), seed=seed)


# --------------------------------------------------------------------- #
# JSONL traces
# --------------------------------------------------------------------- #

# (arrival_time, prompt_len, output_len, slo_class, model-or-None)
TraceRecord = Tuple[float, int, int, str, Optional[str]]


def trace_lines(reqs: Iterable[Request]) -> List[str]:
    """One JSONL record per request.  The ``slo_class`` and ``model``
    keys are written only for tagged requests, so single-tenant,
    untagged traces stay byte-identical to the legacy three-key
    format."""
    out: List[str] = []
    for r in reqs:
        d = {"arrival_time": r.arrival_time,
             "prompt_len": r.prompt_len,
             "output_len": r.output_len}
        if r.slo_class != DEFAULT_SLO_CLASS:
            d["slo_class"] = r.slo_class
        if r.model is not None:
            d["model"] = r.model
        out.append(json.dumps(d))
    return out


def write_trace(reqs: Iterable[Request], path) -> None:
    """Freeze any generated workload to a JSONL trace file."""
    with open(path, "w") as f:
        for line in trace_lines(reqs):
            f.write(line + "\n")


def _parse_trace(lines: Iterable[str]) -> Tuple[TraceRecord, ...]:
    records: List[TraceRecord] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        model = d.get("model")
        records.append((float(d["arrival_time"]), int(d["prompt_len"]),
                        int(d["output_len"]),
                        # untagged legacy JSONL loads as the default class
                        str(d.get("slo_class", DEFAULT_SLO_CLASS)),
                        None if model is None else str(model)))
    return tuple(records)


@dataclasses.dataclass(frozen=True)
class TraceReplay:
    """Replays a frozen trace; arrivals past ``duration`` are dropped so
    a long trace can drive a short experiment.

    ``loop=True`` tiles the trace instead: when the experiment window
    outlives the trace span, the record sequence repeats end-to-end
    (each pass offset by span + one mean inter-arrival gap, so the
    time-averaged rate carries across the seam) until ``duration`` is
    covered — a short rate-normalized excerpt can then drive a long
    cell without most of the window being silent.
    """
    name: str
    records: Tuple[TraceRecord, ...]
    loop: bool = False

    @property
    def rate(self) -> float:
        """Time-averaged arrival rate over the trace span (0.0 for
        traces too short to define one); lets ``run_once`` label result
        rows with the rate actually replayed."""
        if len(self.records) < 2:
            return 0.0
        span = self.records[-1][0] - self.records[0][0]
        return (len(self.records) - 1) / span if span > 0 else 0.0

    def generate(self, duration: float = None) -> List[Request]:
        reqs: List[Request] = []
        tiled = (self.loop and duration is not None
                 and len(self.records) >= 2 and self.rate > 0)
        passes = 1
        stride = 0.0
        if tiled:
            span = self.records[-1][0] - self.records[0][0]
            stride = span + 1.0 / self.rate     # seam gap = mean gap
            passes = max(1, math.ceil(duration / stride))
        rid = 0
        for k in range(passes):
            off = k * stride
            for t, plen, olen, cls, model in self.records:
                t = t + off
                if duration is not None and t >= duration:
                    continue
                reqs.append(Request(rid=rid, arrival_time=t,
                                    prompt_len=plen, output_len=olen,
                                    slo_class=cls, model=model))
                rid += 1
        return reqs

    @staticmethod
    def from_requests(name: str, reqs: Sequence[Request]) -> "TraceReplay":
        return TraceReplay(name, _parse_trace(trace_lines(reqs)))

    @staticmethod
    def from_jsonl(path, name: str = None) -> "TraceReplay":
        with open(path) as f:
            records = _parse_trace(f)
        return TraceReplay(name or f"replay:{path}", records)


@dataclasses.dataclass(frozen=True)
class RoundTripReplay:
    """Generates a base scenario, freezes it through the JSONL codec, and
    replays the frozen form — the runner's default trace-replay cell, so
    every sweep exercises the serialize -> replay path end to end."""
    base: Scenario
    name: str = "replay"

    def generate(self, duration: float) -> List[Request]:
        frozen = trace_lines(self.base.generate(duration))
        return TraceReplay(self.name, _parse_trace(frozen)).generate(duration)


# --------------------------------------------------------------------- #
# factory
# --------------------------------------------------------------------- #

SCENARIO_KINDS = ("poisson", "bursty", "diurnal", "ramp", "replay")

# Named interruption traces: fault-spec strings (``repro_torch.faults``
# grammar) reachable as ``faults="itrace:<name>"`` in ``run_once`` and
# grid cells, so benchmarks pin a fault shape by name the way scenarios
# pin an arrival shape.  "gentle" is one crash plus one spot preemption
# at fixed times (the CI smoke shape); "stormy" layers stochastic spot
# churn, crashes, and a straggler on top — the spec's mtbf clauses draw
# their event times from the schedule's own seeded RNG, so every cell
# seed gets a distinct but reproducible storm.
INTERRUPTION_TRACES = {
    "gentle": "crash:t=14;preempt:t=26,notice=2",
    "stormy": "spot:mtbf=16,notice=2;crash:mtbf=30;slow:t=10,factor=2,dur=8",
}


def make_scenario(kind: str, profile: Union[str, WorkloadProfile],
                  rate: float, seed: int = 0, **kw):
    """Build a scenario by kind at a time-averaged ``rate``.

    ``kind='replay'`` replays ``kw['trace']`` (a JSONL path) if given,
    else round-trips a Poisson workload through the trace codec.
    ``kind='trace:<fixture>'`` (``"trace:azure"``, ``"trace:burstgpt"``)
    replays a converted real-trace excerpt (``repro_torch.traces``)
    rate-normalized to ``rate`` — the replay is frozen data, so
    ``profile`` and ``seed`` do not perturb it (lengths come from the
    trace; the rate knob is a pure time dilation), but grids can still
    sweep rates over real traffic shapes.
    ``kind='shift:<w0>,<w1>[,...]'`` runs piecewise-stationary Poisson
    phases weighted by the listed factors (``PhasedArrivals``; the
    time-averaged rate stays ``rate``) — per-tenant shift shapes are how
    a fleet cell's traffic mix moves between models mid-run.
    """
    if kind.startswith("trace:"):
        if kw:
            raise TypeError(f"trace kinds take no extra options, got {kw}")
        # lazy: repro_torch.traces imports this module for the replay codec
        from repro_torch.traces import fixture_replay
        return fixture_replay(kind[len("trace:"):], rate=rate, loop=True)
    if isinstance(profile, str):
        profile = WORKLOADS[profile]
    if kind.startswith("shift:"):
        if kw:
            raise TypeError(f"shift kinds take no extra options, got {kw}")
        weights = tuple(float(x) for x in kind[len("shift:"):].split(","))
        return Scenario(kind, profile, PhasedArrivals(rate, weights), seed)
    if kind == "poisson":
        if kw:
            raise TypeError(f"poisson takes no extra options, got {kw}")
        return Scenario(kind, profile, PoissonArrivals(rate), seed)
    if kind == "bursty":
        return Scenario(kind, profile, BurstyArrivals(rate, **kw), seed)
    if kind == "diurnal":
        return Scenario(kind, profile, DiurnalArrivals(rate, **kw), seed)
    if kind == "ramp":
        return Scenario(kind, profile, RampArrivals(rate, **kw), seed)
    if kind == "replay":
        trace = kw.pop("trace", None)
        if kw:
            raise TypeError(f"replay takes only 'trace', got {kw}")
        if trace is not None:
            return TraceReplay.from_jsonl(trace)
        base = Scenario("replay-base", profile, PoissonArrivals(rate), seed)
        return RoundTripReplay(base)
    raise KeyError(f"unknown scenario kind {kind!r}; "
                   f"expected one of {SCENARIO_KINDS}")
