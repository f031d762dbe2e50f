"""Service-level objectives and attainment metrics (paper Table 4).

Multi-tenant extension: production traffic mixes the paper's Table 4
workloads, each with its own TTFT budget ("Inference without
Interference").  ``SLOClassSet`` maps a request's ``slo_class`` tag to
its own ``SLO``; ``attainment_by_class`` scores each class against its
own budget so a DistServe-style goodput search can bisect on the
*min-over-classes* attainment instead of the aggregate (one starved
tenant caps the frontier).  A single-class set is behaviourally
identical to passing the bare ``SLO`` everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Tuple, Union

from repro_torch.core.request import Request

DEFAULT_SLO_CLASS = "default"


@dataclasses.dataclass(frozen=True)
class SLO:
    ttft: float      # seconds
    tpot: float      # seconds per output token


# Table 4: SLOs depend only on the application, not the model size.
DATASET_SLOS: Dict[str, SLO] = {
    "alpaca": SLO(ttft=1.0, tpot=0.100),
    "sharegpt": SLO(ttft=5.0, tpot=0.100),
    "longbench": SLO(ttft=15.0, tpot=0.100),
}


@dataclasses.dataclass(frozen=True)
class SLOClassSet:
    """Immutable ``slo_class`` tag -> ``SLO`` mapping.

    ``default`` names the class used for requests whose tag is unknown
    (legacy untagged traffic carries ``DEFAULT_SLO_CLASS``); it must be a
    key of ``classes``.
    """
    classes: Tuple[Tuple[str, SLO], ...]
    default: str

    def __post_init__(self):
        if not self.classes:
            raise ValueError("SLOClassSet needs at least one class")
        by_name = dict(self.classes)
        if self.default not in by_name:
            raise KeyError(f"default class {self.default!r} not among "
                           f"{sorted(by_name)}")
        # lookup cache (non-field: routing resolves a class per request)
        object.__setattr__(self, "_by_name", by_name)

    @staticmethod
    def make(classes: Mapping[str, SLO],
             default: str = None) -> "SLOClassSet":
        items = tuple(sorted(classes.items()))
        if default is None:
            default = (DEFAULT_SLO_CLASS if DEFAULT_SLO_CLASS in classes
                       else items[0][0])
        return SLOClassSet(items, default)

    @staticmethod
    def single(slo: SLO, name: str = DEFAULT_SLO_CLASS) -> "SLOClassSet":
        return SLOClassSet(((name, slo),), name)

    # ---- views -------------------------------------------------------- #
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.classes)

    @property
    def is_single(self) -> bool:
        return len(self.classes) == 1

    @property
    def default_slo(self) -> SLO:
        return self._by_name[self.default]

    def get(self, name: str) -> SLO:
        return self._by_name.get(name, self._by_name[self.default])

    def for_request(self, req: Request) -> SLO:
        return self.get(req.slo_class)

    # scalar shims: schedulers sized against "the" SLO (queue timeouts,
    # instance defaults) use the default class's budgets
    @property
    def ttft(self) -> float:
        return self.default_slo.ttft

    @property
    def tpot(self) -> float:
        return self.default_slo.tpot


def as_slo_class_set(slo: Union[SLO, SLOClassSet]) -> SLOClassSet:
    """Coerce a bare ``SLO`` (the pre-multi-tenant calling convention) to
    a single-class set; pass ``SLOClassSet`` through unchanged."""
    if isinstance(slo, SLOClassSet):
        return slo
    return SLOClassSet.single(slo)


def request_meets_slo(req: Request, slo: SLO) -> bool:
    if req.ttft is None or req.ttft > slo.ttft:
        return False
    if req.tokens_generated > 1:
        return req.avg_tpot is not None and req.avg_tpot <= slo.tpot
    return True


def attainment(reqs: Iterable[Request], slo: SLO) -> float:
    done = [r for r in reqs if r.finish_time is not None]
    if not done:
        return 0.0
    ok = sum(1 for r in done if request_meets_slo(r, slo))
    return ok / len(done)


def attainment_summary(reqs: Iterable[Request], classes: SLOClassSet
                       ) -> Tuple[float, Dict[str, float]]:
    """One scoring pass -> (aggregate, per-class grid).

    Every class in ``classes`` gets a grid key, scored only over that
    class's finished requests against that class's budget; a class with
    no finished requests reports 0.0 (matching the scalar ``attainment``
    convention for an empty set).  Requests tagged with an unknown class
    are scored under the default class.  The aggregate is the same
    every-request-against-its-own-budget ratio the per-class counts
    imply — one pass keeps the two views arithmetically inseparable."""
    buckets: Dict[str, List[Request]] = {n: [] for n in classes.names}
    for r in reqs:
        name = r.slo_class if r.slo_class in buckets else classes.default
        buckets[name].append(r)
    per: Dict[str, float] = {}
    ok_total = done_total = 0
    for name, rs in buckets.items():
        slo = classes.get(name)
        done = [r for r in rs if r.finish_time is not None]
        ok = sum(1 for r in done if request_meets_slo(r, slo))
        per[name] = ok / len(done) if done else 0.0
        ok_total += ok
        done_total += len(done)
    agg = ok_total / done_total if done_total else 0.0
    return agg, per


def attainment_mixed(reqs: Iterable[Request],
                     classes: SLOClassSet) -> float:
    """Aggregate attainment with every request scored against its OWN
    class budget.  Identical to ``attainment(reqs, slo)`` when
    ``classes`` holds a single class equal to ``slo``."""
    return attainment_summary(reqs, classes)[0]


def attainment_by_class(reqs: Iterable[Request],
                        classes: SLOClassSet) -> Dict[str, float]:
    """Per-class attainment grid (see ``attainment_summary``)."""
    return attainment_summary(reqs, classes)[1]


def percentile_latencies(reqs: List[Request]) -> Dict[str, float]:
    import numpy as np
    done = [r for r in reqs if r.finish_time is not None]
    out: Dict[str, float] = {"n": float(len(done))}
    if not done:
        return out
    ttfts = np.array([r.ttft for r in done])
    tpots = np.array([r.avg_tpot for r in done if r.avg_tpot is not None])
    for p in (50, 90, 99):
        out[f"ttft_p{p}"] = float(np.percentile(ttfts, p))
        if len(tpots):
            out[f"tpot_p{p}"] = float(np.percentile(tpots, p))
    return out
