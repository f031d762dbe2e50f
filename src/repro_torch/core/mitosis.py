"""Mitosis scaling (paper §3.5) + the serializable InstanceHandler proxy.

Expansion: instances are added to a macro instance until its size exceeds
``N_u``; then a new macro instance of ``N_l`` instances splits off
(Fig. 7 step 2).  Further instances go to the original until it is full
again, then to the new one.

Contraction: instances are removed from the smallest macro instance until
it reaches ``N_l``; then from a full one; when the two smallest macro
instances together hold ``N_u`` instances, they merge after one more
removal (Fig. 7 steps 5-8).

Migration between macro instances moves an ``InstanceHandler`` — a
pickle-serializable proxy (actor id, worker address, callable registry
reference) — NOT the instance process itself: the instance keeps executing
through the move (<100 ms in the paper; a pickle round-trip here).
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.instance import Instance
from repro_torch.core.macro import MacroInstance
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO, SLOClassSet, as_slo_class_set
from repro_torch.obs.events import NULL_TRACER

# process-local registry standing in for the RPC actor table: handlers
# resolve their instance through it after deserialization, which is what
# makes migration purely *logical* (no re-initialization).
_ACTOR_REGISTRY: Dict[int, Instance] = {}


def register_instance(inst: Instance) -> None:
    _ACTOR_REGISTRY[inst.iid] = inst


def unregister_instance(inst: Instance) -> None:
    """Inverse of ``register_instance``: contraction, merge cleanup, and
    fault teardown must drop the actor-table entry, or the registry grows
    without bound and stale handlers silently resolve dead instances."""
    _ACTOR_REGISTRY.pop(inst.iid, None)


def registry_size() -> int:
    """Test/diagnostic hook: current actor-table population."""
    return len(_ACTOR_REGISTRY)


class StaleHandlerError(LookupError):
    """An ``InstanceHandler`` pointed at an actor that is no longer
    registered (retired by contraction or torn down by a fault)."""


@dataclasses.dataclass
class InstanceHandler:
    """Serializable proxy for an instance (paper §3.5.2)."""
    actor_id: int
    worker_address: str
    capabilities: Dict[str, Any]

    def resolve(self) -> Instance:
        inst = _ACTOR_REGISTRY.get(self.actor_id)
        if inst is None:
            raise StaleHandlerError(
                f"actor {self.actor_id} is not registered (instance "
                "retired or lost); the handler is stale")
        if not getattr(inst, "alive", True):
            raise StaleHandlerError(
                f"actor {self.actor_id} resolved to a dead instance "
                "(crashed or preempted); the handler is stale")
        return inst

    def serialize(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def deserialize(blob: bytes) -> "InstanceHandler":
        return pickle.loads(blob)

    @staticmethod
    def for_instance(inst: Instance, address: str = "local:0",
                     **caps: Any) -> "InstanceHandler":
        register_instance(inst)
        return InstanceHandler(actor_id=inst.iid, worker_address=address,
                               capabilities=dict(caps))


@dataclasses.dataclass
class MigrationRecord:
    src_macro: int
    dst_macro: int
    actor_id: int
    seconds: float


class OverallScheduler:
    """Top-level scheduler: dispatches to macro instances and runs the
    mitosis expansion/contraction state machine."""

    # flight-recorder hook; ``new_macro`` propagates it to every macro
    # instance so rotations minted after attachment are captured too
    tracer = NULL_TRACER

    def __init__(self, slo, predict_prefill: Callable[[int], float],
                 n_lower: int = 4, n_upper: int = 16,
                 conservative: bool = False, reachable=None):
        """``slo`` is a bare ``SLO`` or a multi-tenant ``SLOClassSet``;
        dispatch hands the class set down to every macro instance so each
        request is admitted against its own class budgets.  ``reachable``
        is the transport's (iid, now) -> bool health view; macro routing
        fails over around unreachable instances under network faults."""
        assert 1 <= n_lower <= n_upper
        self.slo_set: SLOClassSet = as_slo_class_set(slo)
        self.slo: SLO = self.slo_set.default_slo
        self.predict_prefill = predict_prefill
        self.n_lower = n_lower
        self.n_upper = n_upper
        self.conservative = conservative
        self.reachable = reachable
        self.macros: List[MacroInstance] = []
        self._next_mid = 0
        self.migrations: List[MigrationRecord] = []

    # ---------------- dispatch ---------------------------------------- #
    def dispatch(self, req: Request, now: float) -> Instance:
        """Route to macro instances (least-loaded first); fall back to
        forced admission on the emptiest one."""
        order = sorted(self.macros, key=lambda m: m.utilization(now))
        for m in order:
            inst = m.route(req, now)
            if inst is not None:
                return inst
        return order[0].route_forced(req, now)

    # ---------------- expansion --------------------------------------- #
    def new_macro(self, instances: List[Instance]) -> MacroInstance:
        m = MacroInstance(self._next_mid, instances, self.slo_set,
                          self.predict_prefill,
                          conservative=self.conservative,
                          reachable=self.reachable)
        self._next_mid += 1
        self.macros.append(m)
        if self.tracer.enabled:
            m.tracer = self.tracer
        return m

    def add_instance(self, inst: Instance) -> MacroInstance:
        """Mitosis expansion: fill the largest non-full macro instance;
        split when it would exceed N_u."""
        register_instance(inst)
        if not self.macros:
            return self.new_macro([inst])
        candidates = [m for m in self.macros if m.size < self.n_upper]
        if candidates:
            # fill the fullest non-full macro first (Fig. 7 steps 1 & 3)
            target = max(candidates, key=lambda m: m.size)
            target.add_instance(inst)
            return target
        # all full -> split: N_l instances seed a new macro (step 2)
        target = max(self.macros, key=lambda m: m.size)
        seeds = [target.remove_instance() for _ in range(self.n_lower - 1)]
        seeds = [s for s in seeds if s is not None] + [inst]
        new = self.new_macro(seeds)
        trc = self.tracer
        if trc.enabled:
            trc.instance(trc.now(), inst.iid, "split")
        for s in seeds[:-1]:
            self._record_migration(target.mid, new.mid, s)
        return new

    # ---------------- contraction -------------------------------------- #
    def remove_instance(self) -> Optional[Instance]:
        """Mitosis contraction: shrink the smallest macro down to N_l, then
        shrink a full one; merge the two smallest when they jointly hold
        N_u (Fig. 7 steps 5-8)."""
        if not self.macros:
            return None
        smallest = min(self.macros, key=lambda m: m.size)
        if smallest.size > self.n_lower or len(self.macros) == 1:
            victim = smallest
        else:
            victim = max(self.macros, key=lambda m: m.size)
        inst = victim.remove_instance()
        if victim.size == 0:
            self.macros.remove(victim)
        self._maybe_merge()
        if inst is not None:
            # the retired instance drains outside the pool; its actor
            # entry goes with it so stale handlers fail loudly
            unregister_instance(inst)
        return inst

    def discard_instance(self, inst: Instance) -> bool:
        """Remove a *specific* instance (fault teardown: crash or spot
        preemption picked the victim, not the contraction heuristic).
        Returns False when the instance is not in any macro."""
        for m in self.macros:
            if m.remove_specific(inst):
                if m.size == 0:
                    self.macros.remove(m)
                self._maybe_merge()
                unregister_instance(inst)
                return True
        return False

    def _maybe_merge(self) -> None:
        if len(self.macros) < 2:
            return
        by_size = sorted(self.macros, key=lambda m: m.size)
        a, b = by_size[0], by_size[1]
        if a.size + b.size <= self.n_upper:
            trc = self.tracer
            if trc.enabled:
                trc.instance(trc.now(), a.mid, "merge")
            # merge a into b via handler migration
            while a.size:
                inst = a.remove_instance()
                if inst is None:
                    break
                self._record_migration(a.mid, b.mid, inst)
                b.add_instance(inst)
            self.macros.remove(a)

    # ---------------- handler migration -------------------------------- #
    def _record_migration(self, src: int, dst: int, inst: Instance) -> None:
        t0 = time.perf_counter()
        handler = InstanceHandler.for_instance(inst)
        blob = handler.serialize()                 # leaves src scheduler
        restored = InstanceHandler.deserialize(blob)   # arrives at dst
        resolved = restored.resolve()
        assert resolved is inst                    # logical migration only
        dt = time.perf_counter() - t0
        self.migrations.append(
            MigrationRecord(src_macro=src, dst_macro=dst,
                            actor_id=inst.iid, seconds=dt))

    # ---------------- views -------------------------------------------- #
    @property
    def total_instances(self) -> int:
        return sum(m.size for m in self.macros)

    def sizes(self) -> List[int]:
        return sorted(m.size for m in self.macros)
