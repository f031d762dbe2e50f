"""The formal ``ServingSystem`` protocol and the shared policy core.

``ServingSystem`` is the contract the simulation engine (and the
real-exec server) drives: ``submit`` new requests, get ``on_slot_end``
callbacks at every slot boundary, ``scale_up``/``scale_down`` under the
mitosis benchmarks, and ``describe()`` the strategy composition so every
result row is self-documenting.

``PolicySystemBase`` is the one implementation of the queue/retry/drain
machinery that used to be copy-pasted (or absent) across
``padg_system.py`` and the baselines.  Behaviour is composed from three
policies (``repro_torch.core.policies``):

    submit(req)        -> admission.try_admit -> routing.place/select
                          (queued on refusal)
    on_slot_end(...)   -> drain the queue in queue_discipline order
                          (instance states just changed)
    scale_up/down      -> routing.add_instance / routing.remove_instance

The drain loop is bounded per call (``max_tries``, 4 consecutive
failures) so an overload backlog cannot make every slot boundary
O(queue); with the FIFO discipline it is bit-identical to the
pre-policy-API deque loop, which is what keeps the golden grids
reproducing exactly through the redesigned construction path.
"""
from __future__ import annotations

from collections import deque
from typing import (Any, Deque, Dict, List, Optional, Protocol,
                    runtime_checkable)

from repro_torch.core.instance import Instance
from repro_torch.core.mitosis import unregister_instance
from repro_torch.core.policies import (AdmissionPolicy, FIFODiscipline,
                                 QueueDiscipline, RoutingPolicy,
                                 make_admission, make_queue_discipline,
                                 make_routing)
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO, SLOClassSet, as_slo_class_set
from repro_torch.core.transport import Transport
from repro_torch.faults.policies import FailurePolicy, make_failure_policy
from repro_torch.obs.events import NULL_TRACER, attach_decision_log


@runtime_checkable
class ServingSystem(Protocol):
    """What the discrete-event engine (and the mitosis benchmarks)
    require of any serving strategy."""

    instances: List[Instance]

    def submit(self, req: Request, now: float, engine) -> None:
        """A request arrived; admit it somewhere or queue it."""
        ...

    def on_slot_end(self, inst: Instance, kind: str, reqs: List[Request],
                    now: float, engine) -> None:
        """An instance finished a slot (prefill batch / decode iteration
        / FuDG hand-off); instance states just changed."""
        ...

    def scale_up(self, engine=None) -> Optional[Instance]:
        """Add one instance to the serving pool (mitosis expansion)."""
        ...

    def scale_down(self, now: Optional[float] = None,
                   engine=None) -> Optional[Instance]:
        """Retire one instance (mitosis contraction); its in-flight work
        is drained or resubmitted per the system's ``FailurePolicy``."""
        ...

    def describe(self) -> Dict[str, Any]:
        """Self-documenting policy composition (JSON/pickle-safe)."""
        ...


class PolicySystemBase:
    """Shared queue/retry/drain core; strategies differ only in their
    policy bundle, instance construction, and (for FuDG) the KV
    hand-off hook."""

    # family identity + declarative policy defaults (overridden per class;
    # ``StrategySpec.describe`` reads these to resolve None policy slots)
    base_name = "base"
    default_queue = "fifo"
    default_admission = "immediate"
    default_routing = "least-kv"
    default_failure = "drop"

    # Flight-recorder hook (repro_torch.obs): NULL_TRACER keeps the hot path
    # allocation-free — one attribute read per emission site.
    tracer = NULL_TRACER
    _decision_log: Optional[List] = None

    @property
    def decision_log(self) -> Optional[List]:
        """Compat shim for the PR 8 scheduling-decision trace: attaching
        a list installs it as a tracer mirror, so every admission outcome
        is appended as ("admit"|"queue"|"drain", now, rid[, iid]) through
        the event bus.  The engines log slot events into the same list,
        so one sequence totally orders the scheduling decisions a run
        makes.  None (the default) keeps the hot path allocation-free."""
        return self._decision_log

    @decision_log.setter
    def decision_log(self, log: Optional[List]) -> None:
        attach_decision_log(self, log)

    def __init__(self, cost, n_instances: int, slo=None, *,
                 queue_discipline=None, admission=None, routing=None,
                 failure=None, iid_base: int = 0):
        """``slo`` is a bare ``SLO``, an ``SLOClassSet``, or None for the
        SLO-blind baselines; policies may be declarative strings
        (``"timeout-forced:4"``) or policy instances.  ``failure``
        (``"drop"`` / ``"resubmit:K"`` / ``"migrate:K"``,
        ``repro_torch.faults``) decides the fate of in-flight requests when an
        instance crashes, is preempted, or retires under contraction.

        ``iid_base`` offsets every instance id the system mints.  The
        engine's slot table and the mitosis actor registry are keyed by
        ``iid`` globally, so systems sharing one engine (``repro_torch.fleet``
        pools) must mint from disjoint bands; 0 (the default) keeps every
        single-system id — and therefore every golden — exactly as
        before."""
        self.cost = cost
        self.iid_base = iid_base
        self.slo_set: Optional[SLOClassSet] = (
            as_slo_class_set(slo) if slo is not None else None)
        self.slo: Optional[SLO] = (
            self.slo_set.default_slo if self.slo_set is not None else None)
        self.queue_discipline: QueueDiscipline = make_queue_discipline(
            queue_discipline if queue_discipline is not None
            else self.default_queue)
        self.admission: AdmissionPolicy = make_admission(
            admission if admission is not None else self.default_admission)
        self.routing: RoutingPolicy = make_routing(
            routing if routing is not None else self.default_routing)
        self.failure: FailurePolicy = make_failure_policy(
            failure if failure is not None else self.default_failure)
        # describe() reports the failure slot only when a caller pinned
        # it: pre-fault-layer golden rows must keep their exact bundles
        self._failure_explicit = failure is not None
        # iid -> evacuation deadline (inf for migrating planned
        # removals); populated by the fault hooks, checked per slot end
        self._evacuating: Dict[int, float] = {}
        self.fault_stats: Dict[str, int] = {
            "crashes": 0, "preemptions": 0, "slowdowns": 0,
            "planned_removals": 0, "lost": 0, "dropped": 0,
            "resubmitted": 0, "requeued": 0, "migrated": 0}
        self.queue: Deque[Request] = deque()
        self.instances: List[Instance] = []
        # every cross-instance / cross-plane interaction (FuDG KV
        # hand-offs, evacuation RPCs, controller snapshots) routes
        # through the transport; ideal until a fault schedule with
        # network clauses attaches a NetworkModel.  Built before
        # _build(): PaDG construction wires its reachability predicate.
        self.transport = Transport()
        # set by StrategySpec.build; direct construction keeps family name
        self.spec_name: Optional[str] = None
        self.provenance: str = ""
        self._build(n_instances)
        self._next_iid = 1 + max((i.iid for i in self.instances),
                                 default=self.iid_base - 1)

    # ---------------- construction hooks -------------------------------- #
    def _build(self, n_instances: int) -> None:
        for i in range(n_instances):
            self.instances.append(self._make_instance(self.iid_base + i))

    def _make_instance(self, iid: int) -> Instance:
        return Instance(iid, self.cost,
                        kv_capacity_tokens=self.cost.kv_capacity_tokens())

    # ---------------- engine hooks --------------------------------------- #
    def submit(self, req: Request, now: float, engine) -> None:
        inst = self.admission.try_admit(self, req, now)
        trc = self.tracer
        if trc.enabled:
            if inst is not None:
                trc.admit(now, req.rid, inst.iid)
            else:
                trc.enqueue(now, req.rid)
        if inst is not None:
            engine.activate(inst)
        else:
            self.queue.append(req)

    def on_slot_end(self, inst: Instance, kind: str, reqs: List[Request],
                    now: float, engine) -> None:
        if kind == "prefill_handoff":
            self._on_prefill_handoff(inst, reqs, now, engine)
            return
        if self._evacuating and inst.iid in self._evacuating:
            # slot boundaries are the only legal moment to move in-flight
            # work off an instance under a preemption notice / migrating
            # planned removal (slots are uninterruptible)
            self.failure.on_evacuation_slot(self, inst, now, engine)
        # retry queued admissions: instance states just changed
        self._drain_queue(now, engine)

    def _on_prefill_handoff(self, inst: Instance, reqs: List[Request],
                            now: float, engine) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} routed a request to a prefill-only "
            "instance but defines no KV hand-off hook")

    # ---------------- queue ---------------------------------------------- #
    def _drain_queue(self, now: float, engine, max_tries: int = 64) -> None:
        """Retry queued admissions in discipline order; bounded per call
        so an overload backlog cannot make every slot boundary O(queue).
        Requests that fail (or are never reached) keep their arrival
        order in the underlying deque."""
        if not self.queue:
            return
        order = self.queue_discipline.order(self.queue, now, self.slo_set,
                                            limit=max_tries)
        admitted = set()
        tries = 0
        fails = 0
        for req in order:
            if tries >= max_tries or fails >= 4:
                break
            tries += 1
            inst = self.admission.try_admit(self, req, now)
            if inst is not None:
                trc = self.tracer
                if trc.enabled:
                    trc.drain(now, req.rid, inst.iid)
                engine.activate(inst)
                admitted.add(id(req))
                fails = 0
            else:
                fails += 1
        if admitted:
            if isinstance(self.queue_discipline, FIFODiscipline):
                # FIFO drained a prefix of the deque: pop it and push
                # back the survivors — O(tried) per slot boundary, not
                # O(queue) (an overload backlog would otherwise pay a
                # full rebuild on every admitted request)
                for _ in range(len(order)):
                    self.queue.popleft()
                self.queue.extendleft(
                    r for r in reversed(order) if id(r) not in admitted)
            else:
                # priority disciplines admit from anywhere in the deque
                self.queue = deque(
                    r for r in self.queue if id(r) not in admitted)

    # ---------------- mitosis hooks (dynamic scaling bench) -------------- #
    def scale_up(self, engine=None) -> Instance:
        inst = self._make_instance(self._next_iid)
        self._next_iid += 1
        self.instances.append(inst)
        self.routing.add_instance(self, inst)
        trc = self.tracer
        if trc.enabled:
            trc.instance(trc.now(), inst.iid, "scale_up")
        return inst

    def scale_down(self, now: Optional[float] = None,
                   engine=None) -> Optional[Instance]:
        inst = self.routing.remove_instance(self)
        if inst is not None and inst in self.instances:
            self.instances.remove(inst)
        if inst is not None:
            self.fault_stats["planned_removals"] += 1
            trc = self.tracer
            if trc.enabled:
                trc.instance(now if now is not None else trc.now(),
                             inst.iid, "scale_down")
            self.failure.on_planned_removal(self, inst, now, engine)
        return inst

    # ---------------- fault hooks (repro_torch.faults) ------------------------- #
    def detach_instance(self, inst: Instance) -> None:
        """Remove a *specific* instance from the routable pool (fault
        teardown picks the victim, unlike ``scale_down``'s heuristic)."""
        if inst in self.instances:
            self.instances.remove(inst)
        self.routing.discard_instance(self, inst)

    def fault_crash(self, inst: Instance, now: float,
                    engine) -> List[Request]:
        """Unannounced instance loss: the in-flight slot is discarded by
        the engine, the KV cache is gone, and every request on the
        instance flows through the failure policy.  Returns the lost
        requests (post-policy: requeued, migrated, or FAILED)."""
        inst.alive = False
        self.detach_instance(inst)
        # macro routing unregisters through the scheduler; on the
        # baselines nothing else does, and handlers minted during
        # evacuation (migrate:K targets) would leak actor-table entries
        unregister_instance(inst)
        self._evacuating.pop(inst.iid, None)
        lost = list(inst.pending) + list(inst.decoding)
        for r in list(inst.pending):
            inst.remove_pending(r)
        for r in list(inst.decoding):
            inst.remove_decoding(r)
        self.fault_stats["crashes"] += 1
        self.fault_stats["lost"] += len(lost)
        trc = self.tracer
        if trc.enabled:
            trc.instance(now, inst.iid, "crash")
        self.failure.on_instance_fault(self, inst, lost, now, engine)
        if engine is not None:
            self._drain_queue(now, engine)
        return lost

    def fault_preempt(self, inst: Instance, notice: float, now: float,
                      engine) -> None:
        """Spot preemption with a notice window: the instance stops
        receiving new work immediately, keeps executing until
        ``now + notice`` (the failure policy may evacuate work at slot
        boundaries in between), then dies like a crash."""
        self.detach_instance(inst)
        deadline = now + notice
        self._evacuating[inst.iid] = deadline
        self.fault_stats["preemptions"] += 1
        trc = self.tracer
        if trc.enabled:
            trc.instance(now, inst.iid, "preempt")
        self.failure.on_notice(self, inst, deadline, now, engine)
        engine.push_call(deadline, self._preempt_deadline, inst, engine)

    def _preempt_deadline(self, inst: Instance, engine) -> None:
        self._evacuating.pop(inst.iid, None)
        if not inst.alive:
            return
        inst.alive = False
        unregister_instance(inst)
        lost = list(inst.pending) + list(inst.decoding)
        for r in list(inst.pending):
            inst.remove_pending(r)
        for r in list(inst.decoding):
            inst.remove_decoding(r)
        self.fault_stats["lost"] += len(lost)
        trc = self.tracer
        if trc.enabled:
            trc.instance(engine.now, inst.iid, "preempt_dead")
        if lost:
            self.failure.on_instance_fault(self, inst, lost, engine.now,
                                           engine)
            self._drain_queue(engine.now, engine)

    def fault_lost_requests(self, reqs: List[Request], now: float,
                            engine) -> None:
        """Requests lost with no owning instance (e.g. a FuDG KV transfer
        whose decode target died mid-flight)."""
        self.fault_stats["lost"] += len(reqs)
        self.failure.on_instance_fault(self, None, reqs, now, engine)
        if engine is not None:
            self._drain_queue(now, engine)

    # ---------------- self-description ----------------------------------- #
    def describe(self) -> Dict[str, Any]:
        """The live policy composition (strings, ints — pickle/JSON safe;
        the worker boundary round-trips this through pickle)."""
        d = {
            "strategy": self.spec_name or self.base_name,
            "base": self.base_name,
            "queue": self.queue_discipline.describe(),
            "admission": self.admission.describe(),
            "routing": self.routing.describe(),
            "n_instances": len(self.instances),
            "provenance": self.provenance,
        }
        if self._failure_explicit:
            # only when pinned: pre-fault-layer golden rows must keep
            # their exact describe() bundles
            d["failure"] = self.failure.describe()
        return d
