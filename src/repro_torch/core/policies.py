"""Pluggable serving policies: queue disciplines, admission, routing.

The paper frames NoDG/FuDG/PaDG as points in one design space — what
differs between the strategies is *policy* (how requests are queued,
admitted, and routed), not machinery.  This module factors those three
decisions into small strategy objects that ``PolicySystemBase``
(``repro_torch.core.system``) composes:

* ``QueueDiscipline`` — the order in which the system-level waiting
  queue is retried at slot boundaries (FIFO; SLO-priority via earliest
  per-class TTFT deadline; shortest-prompt-first).
* ``AdmissionPolicy`` — whether a request may enter an instance *now*
  (immediate; slack-guarded through constraint-checked routing;
  timeout-forced, the paper's "continuous stream" fallback;
  kv-guard, the slack-guarded NoDG variant holding KV headroom for each
  request's full footprint; backpressure, which defers to the queue
  once the target instance has a full prefill slot of backlog).
* ``RoutingPolicy`` — which instance an admission attempt targets
  (least-KV-loaded replica; round-robin; macro-instance rolling
  activation, Algorithm 1; FuDG prefill/decode partitioning).

Every policy is constructible from a declarative string spec
(``"timeout-forced:4"``) so ``StrategySpec`` (``repro_torch.baselines``) can
name compositions like ``"vllm+priority"`` without code.  ``describe()``
round-trips back to that string, keeping result rows self-documenting.

Policies hold no per-request state of their own (round-robin's cursor is
the one deliberate exception); everything they need is read off the
``system`` passed to each call, so one policy object can be shared by
construction code paths without aliasing hazards.
"""
from __future__ import annotations

import heapq
import itertools
from typing import TYPE_CHECKING, Deque, List, Optional, Union

from repro_torch.core.request import Request

if TYPE_CHECKING:
    from repro_torch.core.instance import Instance
    from repro_torch.core.slo import SLOClassSet


def _fmt(x: float) -> str:
    return f"{x:g}"


# --------------------------------------------------------------------- #
# queue disciplines
# --------------------------------------------------------------------- #


class QueueDiscipline:
    """Orders the system-level waiting queue for a drain pass.

    ``order`` returns the retry order over a snapshot of the queue,
    truncated to ``limit`` entries (the drain loop's try budget: a full
    sort of an overload backlog would put O(n log n) back on the
    per-slot-boundary hot path the PR 2 work flattened —
    ``heapq.nsmallest`` keeps it O(n log limit)).  The base system owns
    the actual membership; failed and untried requests keep their
    arrival order in the underlying deque.
    """

    name = "queue"

    def order(self, queue: Deque[Request], now: float,
              slo_set: Optional["SLOClassSet"],
              limit: Optional[int] = None) -> List[Request]:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


def _truncated(queue: Deque[Request], limit: Optional[int]
               ) -> List[Request]:
    if limit is None or len(queue) <= limit:
        return list(queue)
    return list(itertools.islice(queue, limit))


class FIFODiscipline(QueueDiscipline):
    """Arrival order — bit-identical to the pre-policy deque loop (which
    also never looked past its try budget)."""

    name = "fifo"

    def order(self, queue, now, slo_set, limit=None):
        return _truncated(queue, limit)


class SLOPriorityDiscipline(QueueDiscipline):
    """Earliest-deadline-first over per-class TTFT budgets: a queued
    request's deadline is ``arrival + its own class's TTFT``, so
    tight-TTFT tenants (alpaca, 1 s) jump ahead of lax ones (longbench,
    15 s) until the lax request has genuinely aged into urgency.  With a
    single class (or no SLO attached) this degrades to FIFO order."""

    name = "slo-priority"

    def order(self, queue, now, slo_set, limit=None):
        if slo_set is None:
            return _truncated(queue, limit)

        def deadline(r: Request):
            return (r.arrival_time + slo_set.for_request(r).ttft,
                    r.arrival_time, r.rid)

        if limit is not None:
            return heapq.nsmallest(limit, queue, key=deadline)
        return sorted(queue, key=deadline)


class ShortestPromptDiscipline(QueueDiscipline):
    """Shortest-prompt-first (SJF on prefill work): minimizes mean TTFT
    at the cost of long-prompt fairness — the classic counterpoint to
    EDF for serving queues."""

    name = "shortest-prompt"

    def order(self, queue, now, slo_set, limit=None):
        key = (lambda r: (r.prompt_len, r.arrival_time, r.rid))
        if limit is not None:
            return heapq.nsmallest(limit, queue, key=key)
        return sorted(queue, key=key)


# --------------------------------------------------------------------- #
# routing policies
# --------------------------------------------------------------------- #


class RoutingPolicy:
    """Chooses the instance an admission attempt targets.

    Two entry points: ``select`` picks a candidate *without* admitting
    (used by guard-style admission policies that want to inspect it);
    ``place`` performs the full constraint-checked admission attempt and
    returns the admitted instance or None.  The default ``place`` is
    select-then-admit; macro routing overrides it because Algorithm 1
    fuses the constraint check with admission.
    """

    name = "routing"

    def select(self, system, req: Request,
               now: float) -> Optional["Instance"]:
        raise NotImplementedError

    def place(self, system, req: Request,
              now: float) -> Optional["Instance"]:
        inst = self.select(system, req, now)
        if inst is None:
            return None
        inst.admit(req, now)
        return inst

    def place_forced(self, system, req: Request, now: float) -> "Instance":
        """Admission of last resort (SLO already lost): must admit."""
        inst = self.place(system, req, now)
        if inst is None:
            raise RuntimeError(f"{self.name} routing could not force-admit")
        return inst

    # ---- scaling hooks ------------------------------------------------ #
    def add_instance(self, system, inst: "Instance") -> None:
        """Make a freshly created instance routable (the base system has
        already appended it to ``system.instances``)."""

    def remove_instance(self, system) -> Optional["Instance"]:
        """Pick an instance to retire and stop routing to it; its
        in-flight work stays on it until drained."""
        if not system.instances:
            return None
        return min(system.instances, key=lambda i: i.kv_tokens_used())

    def discard_instance(self, system, inst: "Instance") -> None:
        """Stop routing to a *specific* instance (fault teardown: the
        fault picked the victim, not the retirement heuristic).  The
        base system has already dropped it from ``system.instances``;
        policies with their own membership structures override this."""

    def describe(self) -> str:
        return self.name


def _reachable(system, instances, now):
    """Transport-filtered candidate pool: the same list object on the
    clean plane (zero cost), the reachable subset under network faults.
    Guarded so bare test stand-ins without a transport still work."""
    tr = getattr(system, "transport", None)
    if tr is None or tr.network is None:
        return instances
    return tr.filter_reachable(instances, now)


class LeastKVRouting(RoutingPolicy):
    """vLLM-style: the replica with the fewest outstanding KV tokens."""

    name = "least-kv"

    def select(self, system, req, now):
        pool = _reachable(system, system.instances, now)
        if not pool:
            return None
        return min(pool, key=lambda i: i.kv_tokens_used())


class RoundRobinRouting(RoutingPolicy):
    """Cyclic placement; the cursor is the policy's only state."""

    name = "round-robin"

    def __init__(self):
        self._cursor = 0

    def select(self, system, req, now):
        if not system.instances:
            return None
        inst = system.instances[self._cursor % len(system.instances)]
        self._cursor += 1
        return inst


class MacroLeastUtilizedRouting(RoutingPolicy):
    """EcoServe inter-instance routing: macro instances in ascending
    utilization order, each running Algorithm 1 (sticky rolling
    activation + Algorithm 2 constraint check) via ``MacroInstance.
    route``; forced admission lands on the emptiest instance of the
    least-utilized macro.  Requires the system to expose ``sched``
    (an ``OverallScheduler``)."""

    name = "macro-least-utilized"

    def select(self, system, req, now):
        raise TypeError("macro routing fuses constraint-check and "
                        "admission (Algorithm 1); use place()")

    def place(self, system, req, now):
        for m in sorted(system.sched.macros,
                        key=lambda m: m.utilization(now)):
            inst = m.route(req, now)
            if inst is not None:
                return inst
        return None

    def place_forced(self, system, req, now):
        return system.sched.macros[0].route_forced(req, now)

    def add_instance(self, system, inst):
        system.sched.add_instance(inst)

    def remove_instance(self, system):
        return system.sched.remove_instance()

    def discard_instance(self, system, inst):
        system.sched.discard_instance(inst)


class PrefillPartitionedRouting(RoutingPolicy):
    """FuDG: new requests go to the least-backlogged *prefill* instance;
    decode instances only receive work through the KV hand-off path.
    Requires the system to expose ``prefill_insts``/``decode_insts``."""

    name = "prefill-least-pending"

    def select(self, system, req, now):
        pool = _reachable(system, system.prefill_insts, now)
        if not pool:
            return None
        return min(pool, key=lambda i: i.pending_tokens)

    def add_instance(self, system, inst):
        # decode is the paper's FuDG bottleneck under MHA KV traffic
        system.decode_insts.append(inst)

    def remove_instance(self, system):
        if len(system.decode_insts) <= 1:
            return None
        inst = min(system.decode_insts, key=lambda i: i.kv_tokens_used())
        system.decode_insts.remove(inst)
        return inst

    def discard_instance(self, system, inst):
        # a fault may take either kind — even the last decoder (that IS
        # the FuDG cliff the degradation bench measures)
        if inst in system.prefill_insts:
            system.prefill_insts.remove(inst)
        if inst in system.decode_insts:
            system.decode_insts.remove(inst)


# --------------------------------------------------------------------- #
# admission policies
# --------------------------------------------------------------------- #


class AdmissionPolicy:
    """Decides whether a request enters an instance *now* (returning the
    admitted instance) or stays in the system queue (returning None)."""

    name = "admission"

    def try_admit(self, system, req: Request,
                  now: float) -> Optional["Instance"]:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class ImmediateAdmission(AdmissionPolicy):
    """Admit on arrival wherever routing points (NoDG/FuDG baselines:
    the queue stays empty and all waiting happens inside instances)."""

    name = "immediate"

    def try_admit(self, system, req, now):
        return system.routing.place(system, req, now)


class SlackGuardedAdmission(AdmissionPolicy):
    """Admit only where constraint-checked routing accepts (Algorithm 2
    through ``MacroInstance.route``); otherwise queue — with no forced
    fallback, an unserviceable request waits forever."""

    name = "slack-guarded"

    def try_admit(self, system, req, now):
        return system.routing.place(system, req, now)


class TimeoutForcedAdmission(SlackGuardedAdmission):
    """The paper's continuous-stream admission: slack-guarded, but once a
    request has waited past ``timeout_factor`` x its OWN class's TTFT
    budget the SLO is unreachable anyway — force-admit so it still
    completes (counted as a violation)."""

    name = "timeout-forced"

    def __init__(self, timeout_factor: float = 4.0):
        self.timeout_factor = timeout_factor

    def try_admit(self, system, req, now):
        inst = system.routing.place(system, req, now)
        if inst is not None:
            return inst
        ttft = system.slo_set.for_request(req).ttft
        if now - req.arrival_time > self.timeout_factor * ttft:
            return system.routing.place_forced(system, req, now)
        return None

    def describe(self):
        return f"{self.name}:{_fmt(self.timeout_factor)}"


class KVGuardAdmission(AdmissionPolicy):
    """Slack-guarded NoDG admission: route normally, but admit only when
    the target instance has KV headroom for the request's *whole*
    footprint (prompt + maximum output tokens) inside
    ``headroom_fraction`` x capacity — otherwise the request waits in
    the system queue.  The NoDG counterpart of EcoServe's Algorithm 2
    guard: instead of slack over predicted slot times, a replica
    guards the one resource whose exhaustion it cannot schedule around
    (KV memory), deferring work rather than overcommitting."""

    name = "kv-guard"

    def __init__(self, headroom_fraction: float = 0.9):
        self.headroom_fraction = headroom_fraction

    def try_admit(self, system, req, now):
        inst = system.routing.select(system, req, now)
        if inst is None:
            return None
        footprint = req.prompt_len + req.output_len
        budget = self.headroom_fraction * inst.kv_capacity_tokens
        if inst.kv_tokens_used() + footprint <= budget:
            inst.admit(req, now)
            return inst
        return None

    def describe(self):
        return f"{self.name}:{_fmt(self.headroom_fraction)}"


class BackpressureAdmission(AdmissionPolicy):
    """Defer to the system queue once the routed instance already holds
    ``max_backlog_fraction`` x its ``max_prefill_tokens`` of pending
    prefill work.  On its own this only bounds per-instance backlog; its
    point is composition with a non-FIFO ``QueueDiscipline`` — work that
    would have sat in an instance's arrival-ordered pending list waits
    in the *system* queue instead, where the discipline can reorder it
    (e.g. ``"vllm+priority"``: EDF over per-class TTFT deadlines)."""

    name = "backpressure"

    def __init__(self, max_backlog_fraction: float = 0.125):
        self.max_backlog_fraction = max_backlog_fraction

    def try_admit(self, system, req, now):
        inst = system.routing.select(system, req, now)
        if inst is None:
            return None
        budget = self.max_backlog_fraction * inst.max_prefill_tokens
        if inst.pending_tokens <= budget:
            inst.admit(req, now)
            return inst
        return None

    def describe(self):
        return f"{self.name}:{_fmt(self.max_backlog_fraction)}"


# --------------------------------------------------------------------- #
# declarative construction
# --------------------------------------------------------------------- #

QUEUE_DISCIPLINES = {
    FIFODiscipline.name: FIFODiscipline,
    SLOPriorityDiscipline.name: SLOPriorityDiscipline,
    ShortestPromptDiscipline.name: ShortestPromptDiscipline,
}

ADMISSION_POLICIES = {
    ImmediateAdmission.name: ImmediateAdmission,
    SlackGuardedAdmission.name: SlackGuardedAdmission,
    TimeoutForcedAdmission.name: TimeoutForcedAdmission,
    KVGuardAdmission.name: KVGuardAdmission,
    BackpressureAdmission.name: BackpressureAdmission,
}

ROUTING_POLICIES = {
    LeastKVRouting.name: LeastKVRouting,
    RoundRobinRouting.name: RoundRobinRouting,
    MacroLeastUtilizedRouting.name: MacroLeastUtilizedRouting,
    PrefillPartitionedRouting.name: PrefillPartitionedRouting,
}


def _make(registry, spec, base_cls, kind: str):
    if isinstance(spec, base_cls):
        return spec
    if isinstance(spec, str):
        name, _, arg = spec.partition(":")
        if name not in registry:
            raise KeyError(f"unknown {kind} policy {name!r}; expected one "
                           f"of {tuple(registry)}")
        cls = registry[name]
        return cls(float(arg)) if arg else cls()
    raise TypeError(f"cannot build a {kind} policy from {spec!r}")


def make_queue_discipline(
        spec: Union[str, QueueDiscipline]) -> QueueDiscipline:
    """``"fifo"`` / ``"slo-priority"`` / ``"shortest-prompt"`` or an
    instance (passed through)."""
    return _make(QUEUE_DISCIPLINES, spec, QueueDiscipline, "queue")


def make_admission(spec: Union[str, AdmissionPolicy]) -> AdmissionPolicy:
    """``"immediate"`` / ``"slack-guarded"`` / ``"timeout-forced[:F]"`` /
    ``"kv-guard[:F]"`` / ``"backpressure[:F]"`` (``:F`` is the policy's
    float parameter) or an instance (passed through)."""
    return _make(ADMISSION_POLICIES, spec, AdmissionPolicy, "admission")


def make_routing(spec: Union[str, RoutingPolicy]) -> RoutingPolicy:
    """``"least-kv"`` / ``"round-robin"`` / ``"macro-least-utilized"`` /
    ``"prefill-least-pending"`` or an instance (passed through)."""
    return _make(ROUTING_POLICIES, spec, RoutingPolicy, "routing")
