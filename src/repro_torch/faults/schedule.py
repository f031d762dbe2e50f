"""Seeded, pure-sim-time fault schedules.

A schedule is a list of ``FaultEvent``s fixed *before* the simulation
starts, built from a declarative spec string and a cell seed — never
from live simulation state — so a faulted cell is bit-reproducible
across worker counts and scheduling orders, exactly like the arrival
processes in ``repro_torch.simulator.scenarios``.

Spec grammar: ``;``-separated clauses, each ``<kind>:<k>=<v>,...``:

* ``crash:t=14``            — one unannounced instance loss at t=14
* ``crash:mtbf=30``         — Poisson crashes, mean time between 30 s
* ``preempt:t=26,notice=2`` — spot preemption: 2 s notice, then loss
* ``spot:mtbf=20,notice=2`` — recurring spot preemptions (Poisson)
* ``slow:t=10,factor=3,dur=8`` — straggler: one instance runs 3x slower
  for 8 s (``slow:mtbf=...`` draws recurring slowdowns)

Network clauses (``repro_torch.faults.network``) use positional arguments —
one magnitude plus an optional episode length:

* ``netdelay:ms[:dur]``   — every message +``ms`` milliseconds latency
* ``netloss:p[:dur]``     — per-message loss probability ``p``
* ``netdegrade:F[:dur]``  — link bandwidth divided by ``F``
* ``partition:dur``       — one instance cut off for ``dur`` seconds

With ``dur`` the episode starts at a seeded uniform time in
[0, duration - dur); without it the effect covers the whole run
(``FaultEvent.duration == 0`` encodes "until the end").  The magnitude
rides in ``FaultEvent.factor`` (``netdelay`` converted to seconds).

Victim choice is part of the schedule: every event carries a ``pick``
uniform in [0, 1) drawn at build time; the injector maps it onto the
live pool at fire time (``live[int(pick * len(live))]``).  The RNG is
seeded from CRC32(spec) XOR a Knuth-mixed cell seed — the same recipe
as ``repro_torch.simulator.runner.cell_seed`` — so two cells differing only
in the fault spec draw different schedules while sharing arrivals.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Tuple

import numpy as np

from repro_torch.faults.network import NETWORK_KINDS

FAULT_KINDS = ("crash", "preempt", "slow")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    t: float                 # sim-time the fault fires
    kind: str                # FAULT_KINDS or NETWORK_KINDS
    pick: float              # uniform [0,1) victim selector
    notice: float = 0.0      # preempt: seconds of warning before loss
    factor: float = 1.0      # slow: time multiplier; net: effect value
    duration: float = 0.0    # episode seconds (net: 0 = whole run)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    spec: str
    seed: int
    events: Tuple[FaultEvent, ...]

    def __len__(self) -> int:
        return len(self.events)


def _schedule_seed(spec: str, seed: int) -> int:
    return (zlib.crc32(spec.encode()) ^ (seed * 2654435761)) & 0x7FFFFFFF


def _parse_net_clause(kind: str, argstr: str, clause: str
                      ) -> Tuple[str, List[float]]:
    """Positional network clause: ``kind:value[:dur]`` (``partition`` is
    duration-only)."""
    parts = [p.strip() for p in argstr.split(":")] if argstr else []
    try:
        args = [float(p) for p in parts if p]
    except ValueError:
        raise ValueError(f"malformed network clause {clause!r} "
                         f"(expected {kind}:<float>[:<dur>])")
    if len(args) != len(parts):
        raise ValueError(f"malformed network clause {clause!r} "
                         f"(empty argument)")
    want = (1,) if kind == "partition" else (1, 2)
    if len(args) not in want:
        raise ValueError(
            f"network clause {clause!r} takes "
            f"{'dur' if kind == 'partition' else 'value[:dur]'} "
            f"({' or '.join(map(str, want))} args), got {len(args)}")
    if kind == "netloss" and not 0.0 <= args[0] <= 1.0:
        raise ValueError(f"netloss probability must be in [0, 1], got "
                         f"{args[0]} in {clause!r}")
    if kind == "netdegrade" and args[0] < 1.0:
        raise ValueError(f"netdegrade factor must be >= 1, got "
                         f"{args[0]} in {clause!r}")
    if args[0] < 0.0 or (len(args) > 1 and args[1] <= 0.0):
        raise ValueError(f"network clause {clause!r} needs non-negative "
                         "value and positive dur")
    return kind, args


def _parse_clause(clause: str) -> Tuple[str, dict]:
    kind, _, argstr = clause.partition(":")
    kind = kind.strip()
    if kind == "spot":               # alias: recurring preemption
        kind = "preempt"
    if kind in NETWORK_KINDS:
        return _parse_net_clause(kind, argstr, clause)
    if kind not in FAULT_KINDS:
        raise KeyError(f"unknown fault kind {kind!r}; expected one of "
                       f"{FAULT_KINDS + NETWORK_KINDS} (or 'spot')")
    args = {}
    for part in filter(None, (p.strip() for p in argstr.split(","))):
        k, _, v = part.partition("=")
        if not v:
            raise ValueError(f"malformed fault option {part!r} in "
                             f"{clause!r} (expected k=v)")
        args[k.strip()] = float(v)
    if ("t" in args) == ("mtbf" in args):
        raise ValueError(f"fault clause {clause!r} needs exactly one of "
                         "t= (one-shot) or mtbf= (recurring)")
    known = {"t", "mtbf", "notice", "factor", "dur"}
    unknown = set(args) - known
    if unknown:
        raise ValueError(f"unknown fault options {sorted(unknown)} in "
                         f"{clause!r}; expected {sorted(known)}")
    return kind, args


def make_fault_schedule(spec: str, seed: int,
                        duration: float) -> FaultSchedule:
    """Materialize a spec into a deterministic event list over
    [0, duration).  Clauses draw from one shared RNG stream in clause
    order, so the whole schedule is a pure function of (spec, seed,
    duration)."""
    rng = np.random.default_rng(_schedule_seed(spec, seed))
    events: List[FaultEvent] = []
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        kind, args = _parse_clause(clause)
        if kind in NETWORK_KINDS:
            if kind == "partition":
                value, dur = 0.0, args[0]
            else:
                value = args[0] / 1000.0 if kind == "netdelay" else args[0]
                dur = args[1] if len(args) > 1 else 0.0   # 0 = whole run
            if dur > 0.0:
                # a bounded episode starts at a seeded uniform time
                t = float(rng.uniform(0.0, max(0.0, duration - dur)))
            else:
                t = 0.0
            events.append(FaultEvent(
                t=t, kind=kind, pick=float(rng.random()),
                factor=value, duration=dur))
            continue
        notice = args.get("notice", 0.0)
        factor = args.get("factor", 2.0)
        dur = args.get("dur", 5.0)
        if "t" in args:
            times = [args["t"]]
        else:
            times, t = [], 0.0
            while True:
                t += float(rng.exponential(args["mtbf"]))
                if t >= duration:
                    break
                times.append(t)
        for t in times:
            events.append(FaultEvent(
                t=float(t), kind=kind, pick=float(rng.random()),
                notice=notice, factor=factor, duration=dur))
    events.sort(key=lambda e: (e.t, e.kind, e.pick))
    return FaultSchedule(spec=spec, seed=seed, events=tuple(events))
