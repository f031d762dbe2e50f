"""EcoServe: the PaDG serving system (paper's full stack over the engine).

Combines: temporal disaggregation (Instance), rolling activation +
Algorithm 1 (MacroInstance), Algorithm 2 (constraints), mitosis scaling
(OverallScheduler).  Expressed as a ``PolicySystemBase`` composition:
macro-least-utilized routing (Algorithm 1 over macro instances),
timeout-forced admission (the paper's "continuous stream" rule:
slack-guarded, force-admitted once a request has overstayed its own
class's TTFT budget), and a FIFO drain of the macro-level queue at every
slot boundary.  Swap the queue discipline to get e.g.
``"ecoserve+priority"`` without touching this file.
"""
from __future__ import annotations

from repro_torch.core.instance import Instance
from repro_torch.core.mitosis import OverallScheduler, register_instance
from repro_torch.core.policies import TimeoutForcedAdmission
from repro_torch.core.system import PolicySystemBase
from repro_torch.simulator.cost_model import InstanceCostModel


class EcoServeSystem(PolicySystemBase):
    base_name = "ecoserve"
    default_queue = "fifo"
    default_admission = "timeout-forced:4"
    default_routing = "macro-least-utilized"

    def __init__(self, cost: InstanceCostModel, n_instances: int, slo,
                 n_lower: int = 4, n_upper: int = 16,
                 queue_timeout_factor: float = 4.0,
                 plus_plus: bool = False,
                 chunked_fallback: int = 0,
                 queue_discipline=None, admission=None, routing=None,
                 failure=None, instance_kwargs=None, iid_base: int = 0):
        """``slo`` is a bare ``SLO`` or a multi-tenant ``SLOClassSet``;
        with a class set, admission/routing/slack all run against each
        request's own class budgets (single-class sets are bit-identical
        to the scalar path).

        ``plus_plus`` enables the beyond-paper EcoServe++ admission:
        min-slack (instead of mean-slack) in Constraint 2 and in the
        intra-instance switch guard — protects young decodes.

        ``chunked_fallback`` > 0 enables EcoServe-CP (beyond-paper):
        when slack is too thin for a full prefill slot, that many prefill
        tokens ride along with each decode iteration."""
        self.plus_plus = plus_plus
        self.chunked_fallback = chunked_fallback
        self.n_lower = n_lower
        self.n_upper = n_upper
        self.queue_timeout_factor = queue_timeout_factor
        # extra Instance(...) kwargs (e.g. max_decode_batch /
        # max_prefill_batch for engine-backed conformance runs); must be
        # set before super().__init__ because _build() runs inside it
        self.instance_kwargs = dict(instance_kwargs or {})
        if admission is None:
            admission = TimeoutForcedAdmission(queue_timeout_factor)
        super().__init__(cost, n_instances, slo,
                         queue_discipline=queue_discipline,
                         admission=admission, routing=routing,
                         failure=failure, iid_base=iid_base)

    def _build(self, n_instances: int) -> None:
        self.sched = OverallScheduler(
            self.slo_set, self.cost.predict_prefill, n_lower=self.n_lower,
            n_upper=self.n_upper, conservative=self.plus_plus,
            reachable=self.transport.instance_reachable)
        for i in range(n_instances):
            inst = self._make_instance(self.iid_base + i)
            self.instances.append(inst)
            self.sched.add_instance(inst)

    def _make_instance(self, iid: int) -> Instance:
        inst = Instance(
            iid, self.cost, kv_capacity_tokens=self.cost.kv_capacity_tokens(),
            slo_tpot=self.slo.tpot, slo_ttft=self.slo.ttft,
            conservative_slack=self.plus_plus,
            chunked_fallback=self.chunked_fallback,
            slo_classes=self.slo_set, **self.instance_kwargs)
        register_instance(inst)
        return inst
