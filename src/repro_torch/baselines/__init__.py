"""Declarative strategy layer: ``StrategySpec`` registry + the
``"base+policy"`` grammar + the uniform ``make_system`` factory.

Every serving strategy (EcoServe/PaDG included) is a ``StrategySpec``:
a named, paper-provenanced bundle of (system family, queue discipline,
admission policy, routing policy, constructor kwargs).  ``make_system``
is the single construction point the experiment runner, benchmarks, and
tests share; it resolves either a registered spec name (``"vllm"``,
``"ecoserve++"``) or a grammar composition ``"<base>+<modifier>"``
(``"vllm+priority"``, ``"mooncake+spf"``) — so new scheduling variants
are named in grid specs, not forked in code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.baselines.nodg_vllm import VLLMSystem          # noqa: F401
from repro_torch.baselines.nodg_sarathi import SarathiSystem    # noqa: F401
from repro_torch.baselines.fudg_distserve import DistServeSystem  # noqa: F401
from repro_torch.baselines.fudg_mooncake import MoonCakeSystem  # noqa: F401


# family names are static so spec validation at registration time needs
# no imports; _families() resolves classes lazily (EcoServeSystem pulls
# in the full simulator package, which module-level register() calls
# must not trigger)
FAMILY_NAMES = ("ecoserve", "vllm", "sarathi", "distserve", "mooncake")


def _families() -> Dict[str, type]:
    from repro_torch.core.padg_system import EcoServeSystem
    return {
        "ecoserve": EcoServeSystem,
        "vllm": VLLMSystem,
        "sarathi": SarathiSystem,
        "distserve": DistServeSystem,
        "mooncake": MoonCakeSystem,
    }


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """One named point in the policy design space.

    ``queue``/``admission``/``routing`` are declarative policy strings
    (``repro_torch.core.policies``); None means "the family's default", so a
    spec only pins what it changes.  ``kwargs`` are frozen constructor
    kwargs for the family class; ``provenance`` records where the
    composition comes from (paper section, roadmap item).
    """

    name: str
    base: str                                  # family: ecoserve|vllm|...
    queue: Optional[str] = None
    admission: Optional[str] = None
    routing: Optional[str] = None
    failure: Optional[str] = None              # repro_torch.faults FailurePolicy
    kwargs: Tuple[Tuple[str, Any], ...] = ()
    provenance: str = ""

    def __post_init__(self):
        if self.base not in FAMILY_NAMES:
            raise KeyError(f"unknown system family {self.base!r}")

    @property
    def ctor_kwargs(self) -> Dict[str, Any]:
        return dict(self.kwargs)

    def describe(self) -> Dict[str, Any]:
        """Self-documenting composition with None policy slots resolved
        to the family defaults and policy strings canonicalized through
        the policy constructors (so ``"backpressure"`` reads back with
        its effective parameter, exactly as a live system reports it);
        JSON/pickle-safe, threaded into runner rows and JSONL streams."""
        from repro_torch.core.policies import (make_admission,
                                         make_queue_discipline,
                                         make_routing)
        cls = _families()[self.base]
        d = {
            "strategy": self.name,
            "base": self.base,
            "queue": make_queue_discipline(
                self.queue or cls.default_queue).describe(),
            "admission": make_admission(
                self.admission or cls.default_admission).describe(),
            "routing": make_routing(
                self.routing or cls.default_routing).describe(),
            "kwargs": self.ctor_kwargs,
            "provenance": self.provenance,
        }
        if self.failure is not None:
            # only when pinned, mirroring PolicySystemBase.describe():
            # pre-fault-layer golden rows keep their exact bundles
            from repro_torch.faults import make_failure_policy
            d["failure"] = make_failure_policy(self.failure).describe()
        return d

    def build(self, cost, n_instances: int, slo=None, **overrides):
        """Construct the serving system.  ``overrides`` are caller
        constructor kwargs and win over the spec's frozen ``kwargs``
        (e.g. ``make_system("ecoserve", ..., queue_timeout_factor=2)``)."""
        cls = _families()[self.base]
        kw = {**self.ctor_kwargs, **overrides}
        if self.queue is not None:
            kw.setdefault("queue_discipline", self.queue)
        if self.admission is not None:
            kw.setdefault("admission", self.admission)
        if self.routing is not None:
            kw.setdefault("routing", self.routing)
        if self.failure is not None:
            kw.setdefault("failure", self.failure)
        system = cls(cost, n_instances, slo, **kw)
        system.spec_name = self.name
        system.provenance = self.provenance
        return system


# --------------------------------------------------------------------- #
# the registry (replaces the old ad-hoc name -> constructor dict)
# --------------------------------------------------------------------- #

REGISTRY: Dict[str, StrategySpec] = {}


def register(spec: StrategySpec) -> StrategySpec:
    REGISTRY[spec.name] = spec
    return spec


register(StrategySpec(
    name="ecoserve", base="ecoserve",
    provenance="EcoServe (arXiv:2504.18154) §3: PaDG temporal "
               "disaggregation, Alg. 1 rolling activation, Alg. 2 "
               "admission, mitosis scaling"))
register(StrategySpec(
    name="ecoserve++", base="ecoserve", kwargs=(("plus_plus", True),),
    provenance="beyond-paper EcoServe++: min-slack (conservative) "
               "admission protecting young decodes"))
register(StrategySpec(
    name="vllm", base="vllm",
    provenance="paper §4.1 baseline 1 (vLLM): NoDG replicas, "
               "prefill-priority continuous batching"))
register(StrategySpec(
    name="sarathi", base="sarathi",
    provenance="paper §4.1 baseline 2 (Sarathi-Serve): chunked-prefill "
               "hybrid batching, decode-priority"))
register(StrategySpec(
    name="distserve", base="distserve", kwargs=(("prefill_ratio", 0.25),),
    provenance="paper §4.1 baseline 3 (DistServe): intra-node FuDG, KV "
               "over the node's PCIe link"))
register(StrategySpec(
    name="mooncake", base="mooncake", kwargs=(("prefill_ratio", 0.25),),
    provenance="paper §4.1 baseline 4 (MoonCake): inter-node FuDG "
               "through a central KV pool (two NIC traversals)"))
# SLO-aware NoDG variants (ROADMAP: priority-queue baselines) — first
# clients of the composable policy API; also reachable via the grammar.
register(StrategySpec(
    name="vllm+priority", base="vllm",
    queue="slo-priority", admission="backpressure",
    provenance="ROADMAP SLO-aware NoDG: EDF queue over per-class TTFT "
               "deadlines + backpressure admission on vLLM machinery"))
register(StrategySpec(
    name="sarathi+priority", base="sarathi",
    queue="slo-priority", admission="backpressure",
    provenance="ROADMAP SLO-aware NoDG: EDF queue over per-class TTFT "
               "deadlines + backpressure admission on Sarathi machinery"))
# ROADMAP policy-composition slice (PR 5): a slack-guarded NoDG and a
# routing ablation, both also reachable through the grammar.
register(StrategySpec(
    name="vllm+slack", base="vllm", admission="kv-guard",
    provenance="ROADMAP policy composition: slack-guarded NoDG — "
               "admission holds KV headroom for each request's full "
               "footprint (the Algorithm 2 idea restated for a replica "
               "whose only hard constraint is KV memory)"))
register(StrategySpec(
    name="ecoserve+rr", base="ecoserve", routing="round-robin",
    provenance="ROADMAP policy composition: EcoServe machinery under "
               "blind round-robin placement — ablates Algorithm 1 "
               "inter-instance routing"))
# ROADMAP composition sweep (goodput grid): SLO-aware FuDG and a
# starvation-prone-but-fast PaDG queue.  Bundles mirror the grammar
# exactly (see test_registered_composition_and_grammar_agree): DistServe
# admits immediately, so a queue swap upgrades it to backpressure;
# EcoServe's timeout-forced admission survives, so only the queue moves.
register(StrategySpec(
    name="distserve+priority", base="distserve",
    queue="slo-priority", admission="backpressure",
    kwargs=(("prefill_ratio", 0.25),),
    provenance="ROADMAP composition sweep: EDF queue over per-class "
               "TTFT deadlines + backpressure admission on DistServe's "
               "intra-node FuDG machinery"))
register(StrategySpec(
    name="ecoserve+spf", base="ecoserve", queue="shortest-prompt",
    provenance="ROADMAP composition sweep: shortest-prompt-first queue "
               "on EcoServe PaDG machinery (TTFT-greedy, "
               "starvation-prone under mixed prompt lengths)"))

STRATEGIES: Tuple[str, ...] = tuple(REGISTRY)


# --------------------------------------------------------------------- #
# the "base+modifier" grammar
# --------------------------------------------------------------------- #

def _with_queue(queue: str) -> Callable[[StrategySpec], StrategySpec]:
    """Swap the queue discipline; if the base admits immediately (so its
    queue is always empty and a discipline could never act), upgrade to
    backpressure admission so the queue actually forms."""
    def apply(spec: StrategySpec) -> StrategySpec:
        cls = _families()[spec.base]
        effective = spec.admission or cls.default_admission
        admission = ("backpressure" if effective == "immediate"
                     else spec.admission)     # None keeps family default
        return dataclasses.replace(spec, queue=queue, admission=admission)
    return apply


def _with(field: str, value: str) -> Callable[[StrategySpec], StrategySpec]:
    """Swap one policy slot, other slots untouched.  (``_with_queue``
    stays separate: a queue swap also upgrades immediate admission.)"""
    def apply(spec: StrategySpec) -> StrategySpec:
        return dataclasses.replace(spec, **{field: value})
    return apply


MODIFIERS: Dict[str, Callable[[StrategySpec], StrategySpec]] = {
    "priority": _with_queue("slo-priority"),
    "spf": _with_queue("shortest-prompt"),
    "rr": _with("routing", "round-robin"),
    "slack": _with("admission", "kv-guard"),
    # fault-tolerance slot (repro_torch.faults): fate of in-flight requests
    # when an instance crashes, is preempted, or retires
    "retry": _with("failure", "resubmit:2"),
    "migrate": _with("failure", "migrate"),
    "drop": _with("failure", "drop"),
}


def resolve_strategy(name: str) -> StrategySpec:
    """Registered name, or ``"<base>+<modifier>[+<modifier>...]"`` where
    ``<base>`` is any registered spec (longest match, so ``ecoserve++``
    composes too) and modifiers come from ``MODIFIERS``."""
    if name in REGISTRY:
        return REGISTRY[name]
    for base_name in sorted(REGISTRY, key=len, reverse=True):
        prefix = base_name + "+"
        if not name.startswith(prefix):
            continue
        mods = name[len(prefix):].split("+")
        if not all(m in MODIFIERS for m in mods):
            break
        spec = REGISTRY[base_name]
        for m in mods:
            spec = MODIFIERS[m](spec)
        # compositions must not carry the base's provenance verbatim —
        # a "+spf" variant is NOT the paper's baseline
        provenance = (f"{spec.provenance} — composed with "
                      f"+{'+'.join(mods)} via the strategy grammar")
        return dataclasses.replace(spec, name=name, provenance=provenance)
    raise KeyError(
        f"unknown strategy {name!r}; expected one of {STRATEGIES} or a "
        f"'<base>+<modifier>' composition with modifiers "
        f"{tuple(MODIFIERS)}")


def describe_strategy(name: str) -> Dict[str, Any]:
    """Resolve a strategy name and return its self-documenting policy
    bundle (worker-safe module-level function: the experiment runner
    attaches this to every result row, and the conformance tests map it
    across a spawn pool to prove the pickle round-trip)."""
    return resolve_strategy(name).describe()


def make_system(name: str, cost, n_instances: int, slo=None, **kw):
    """Construct a serving system by strategy name.

    ``slo`` may be a bare ``SLO`` or a multi-tenant ``SLOClassSet``
    (``repro_torch.core.slo``): EcoServe routes each request against its own
    class budgets; the plain NoDG/FuDG baselines schedule SLO-blind
    either way, but SLO-aware compositions (``"vllm+priority"``) read it
    through their queue discipline — and every strategy's results are
    still scored per class by the metrics layer.
    """
    return resolve_strategy(name).build(cost, n_instances, slo, **kw)
