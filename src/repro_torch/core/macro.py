"""Macro instance: rolling activation + Algorithm 1 (inter-instance routing).

A macro instance is EcoServe's basic serving unit: N instances whose
prefill phases are staggered in time.  The scheduler routes each incoming
request *stickily* to the most recently used instance; when that instance
fails the constraint check, it cycles to the next one — this cyclic
hand-off IS the rolling activation (the paper's Fig. 5 step 2).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

from repro_torch.core.constraints import check_constraints
from repro_torch.core.instance import Instance
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO, SLOClassSet, as_slo_class_set
from repro_torch.obs.events import NULL_TRACER


class MacroInstance:
    # flight-recorder hook: rolling-activation rotations are the paper's
    # Fig. 5 step 2 — worth a timeline event each
    tracer = NULL_TRACER

    def __init__(self, mid: int, instances: List[Instance],
                 slo: Union[SLO, SLOClassSet],
                 predict_prefill: Callable[[int], float],
                 conservative: bool = False,
                 reachable: Optional[Callable[[int, float], bool]] = None):
        self.mid = mid
        self.instances: List[Instance] = list(instances)
        # scheduler-side health predicate (iid, now) -> bool; None means
        # an ideal coordination plane.  Under network faults the rolling
        # activation fails over past unreachable instances instead of
        # handing work to a black-holed one.
        self.reachable = reachable
        # accept a bare SLO (legacy single-tenant callers) or a class set;
        # routing always resolves the REQUEST's class (Algorithm 1 becomes
        # SLO-aware: constraints check against the request's own budgets)
        self.slo_set = as_slo_class_set(slo)
        self.slo = self.slo_set.default_slo
        self.predict_prefill = predict_prefill
        self.conservative = conservative       # EcoServe++ admission
        self._active_idx = 0      # sticky pointer (Algorithm 1 line 2)
        self.rejected = 0

    # ------------------------------------------------------------------ #
    def route(self, req: Request, now: float) -> Optional[Instance]:
        """Algorithm 1: try the instance that admitted the previous request;
        on constraint failure check the next instance, cyclically.  Returns
        the chosen instance (request admitted) or None if no instance can
        satisfy the constraints right now."""
        n = len(self.instances)
        if n == 0:
            return None
        slo = self.slo_set.for_request(req)
        for k in range(n):
            idx = (self._active_idx + k) % n
            inst = self.instances[idx]
            if (self.reachable is not None
                    and not self.reachable(inst.iid, now)):
                # fail over: the cycle skips the unreachable instance
                continue
            status = inst.status(now, slo.tpot)
            if check_constraints(status, req, slo,
                                 self.predict_prefill, now,
                                 conservative=self.conservative):
                if idx != self._active_idx:
                    trc = self.tracer
                    if trc.enabled:
                        trc.instance(now, inst.iid, "rotate")
                self._active_idx = idx
                inst.admit(req, now)
                return inst
        return None

    def route_forced(self, req: Request, now: float) -> Instance:
        """Admission of last resort (SLO already lost): pick the instance
        with the most free KV memory so the request still completes.
        Prefers reachable instances; with every one unreachable it still
        admits somewhere (the request would otherwise be dropped)."""
        pool = self.instances
        if self.reachable is not None:
            ok = [i for i in pool if self.reachable(i.iid, now)]
            if ok:
                pool = ok
        inst = max(pool,
                   key=lambda i: i.kv_capacity_tokens - i.kv_tokens_used())
        self.rejected += 1
        inst.admit(req, now)
        idx = self.instances.index(inst)
        if idx != self._active_idx:
            trc = self.tracer
            if trc.enabled:
                trc.instance(now, inst.iid, "rotate")
        self._active_idx = idx
        return inst

    # ------------------------------------------------------------------ #
    def add_instance(self, inst: Instance) -> None:
        self.instances.append(inst)

    def remove_instance(self) -> Optional[Instance]:
        """Remove (and return) the emptiest instance for migration/scaling;
        its in-flight requests stay on it until drained — the caller keeps
        stepping it but routes no new work (paper: migration is triggered
        during the decode phase and never interrupts execution)."""
        if not self.instances:
            return None
        inst = min(self.instances, key=lambda i: i.kv_tokens_used())
        self.instances.remove(inst)
        self._active_idx = 0 if not self.instances else (
            self._active_idx % len(self.instances))
        return inst

    def remove_specific(self, inst: Instance) -> bool:
        """Remove a named instance (fault teardown picks the victim, not
        the emptiest-first heuristic); returns False if absent."""
        if inst not in self.instances:
            return False
        self.instances.remove(inst)
        self._active_idx = 0 if not self.instances else (
            self._active_idx % len(self.instances))
        return True

    @property
    def size(self) -> int:
        return len(self.instances)

    def utilization(self, now: float) -> float:
        if not self.instances:
            return 0.0
        busy = sum(1 for i in self.instances if i.busy)
        return busy / len(self.instances)
