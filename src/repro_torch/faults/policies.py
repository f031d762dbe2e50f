"""Failure policies: what happens to in-flight requests when their
instance goes away.

``PolicySystemBase`` carries one ``FailurePolicy`` next to its queue /
admission / routing policies.  The system's fault hooks (``fault_crash``,
``fault_preempt``, ``scale_down``) detach the instance and hand the
affected requests here; the policy decides their fate:

* ``drop`` (default)  — unplanned losses are terminal: the request is
  marked FAILED and counts as an SLO miss.  Planned removals keep the
  pre-fault behaviour bit-exactly: the retiring instance drains its
  in-flight work in place.
* ``resubmit[:K]``    — lost requests return to the system queue with
  their ORIGINAL ``arrival_time`` (TTFT keeps charging the full wait,
  including the lost work) and a retry budget of K; past the budget
  they are dropped.  Planned removals requeue not-yet-prefilled work
  (nothing is lost — the KV was never built) and let decodes drain.
* ``migrate[:K]``     — spot preemption with a notice window: at the
  next slot boundary (slots are uninterruptible) the instance's decodes
  move to a live peer through the mitosis ``InstanceHandler`` path —
  serialized proxy, token counts intact, no re-prefill — and pending
  prefills requeue.  Unplanned crashes (no notice, KV gone) fall back
  to resubmission with budget K.

All hooks run in sim-time through the engine's event loop; none of them
consults a wall clock or an unseeded RNG, so faulted cells stay
bit-reproducible.
"""
from __future__ import annotations

from typing import List, Optional, Union

from repro_torch.core.instance import Instance
from repro_torch.core.request import Request, RequestState
from repro_torch.obs.events import NULL_TRACER


def _fmt(x: float) -> str:
    return f"{x:g}"


class FailurePolicy:
    """Decides the fate of requests whose instance faulted or retired."""

    name = "failure"

    # ---- hook points (called by PolicySystemBase) --------------------- #
    def on_instance_fault(self, system, inst: Optional[Instance],
                          reqs: List[Request], now: float, engine) -> None:
        """Unplanned loss: ``reqs`` were on ``inst`` (already detached and
        dead) when it crashed or hit its preemption deadline.  ``inst`` is
        None for requests lost in transit (FuDG KV hand-off to a dead
        decode instance)."""
        raise NotImplementedError

    def on_notice(self, system, inst: Instance, deadline: float,
                  now: float, engine) -> None:
        """A preemption notice arrived: ``inst`` stops receiving new work
        now and dies at ``deadline``.  Default: drain what the window
        allows; leftovers reach ``on_instance_fault`` at the deadline."""

    def on_evacuation_slot(self, system, inst: Instance, now: float,
                           engine) -> None:
        """A slot just completed on an instance under evacuation (notice
        window or migrating planned removal) — the only moment in-flight
        work may legally move (slots are uninterruptible)."""

    def on_planned_removal(self, system, inst: Instance,
                           now: Optional[float], engine) -> None:
        """Contraction chose ``inst``: it left the routable pool but is
        still alive.  Default: drain in place (the pre-fault-layer
        behaviour, bit-exact)."""

    # ---- shared helpers ----------------------------------------------- #
    @staticmethod
    def _drop(system, req: Request) -> None:
        req.state = RequestState.FAILED
        req.instance_id = None
        system.fault_stats["dropped"] += 1
        # getattr: fault hooks also run against bare test stubs that
        # don't inherit PolicySystemBase's tracer attribute
        trc = getattr(system, "tracer", NULL_TRACER)
        if trc.enabled:
            trc.fail(trc.now(), req.rid, "dropped")

    def describe(self) -> str:
        return self.name


class DropFailure(FailurePolicy):
    """Terminal losses: faulted requests never finish and score as SLO
    misses.  The honest baseline — degradation curves under this policy
    measure raw capacity loss, with no retry machinery blurring it."""

    name = "drop"

    def on_instance_fault(self, system, inst, reqs, now, engine):
        for r in reqs:
            self._drop(system, r)


class ResubmitFailure(FailurePolicy):
    """Lost requests go back to the system queue (original arrival time,
    zeroed execution state) with a bounded retry budget."""

    name = "resubmit"

    def __init__(self, budget: float = 2.0):
        self.budget = int(budget)

    def describe(self) -> str:
        return f"{self.name}:{_fmt(self.budget)}"

    def _resubmit(self, system, req: Request, charge: bool = True) -> bool:
        """Return the request to the queue for a fresh admission attempt.
        ``charge`` spends a unit of retry budget (unplanned losses);
        planned evacuations of not-yet-prefilled work are free — no KV
        was lost, the request merely returns to the line it came from."""
        if charge:
            if req.retries >= self.budget:
                self._drop(system, req)
                return False
            req.retries += 1
            system.fault_stats["resubmitted"] += 1
        else:
            system.fault_stats["requeued"] += 1
        req.state = RequestState.QUEUED
        req.admitted_time = None
        req.first_token_time = None
        req.second_token_time = None
        req.finish_time = None
        req.tokens_generated = 0
        req.instance_id = None
        system.queue.append(req)
        trc = getattr(system, "tracer", NULL_TRACER)
        if trc.enabled:
            trc.requeue(trc.now(), req.rid)
        return True

    def on_instance_fault(self, system, inst, reqs, now, engine):
        for r in reqs:
            self._resubmit(system, r, charge=True)

    def on_planned_removal(self, system, inst, now, engine):
        # pending prefills lose nothing by requeueing (no KV built yet)
        # and regain access to the whole pool; decodes drain in place —
        # their KV is resident and killing it would waste finished work
        for r in list(inst.pending):
            inst.remove_pending(r)
            _clear_chunk_progress(inst, r)
            self._resubmit(system, r, charge=False)
        if engine is not None:
            system._drain_queue(now if now is not None else engine.now,
                                engine)


class MigrateFailure(ResubmitFailure):
    """Notice-window migration through the mitosis ``InstanceHandler``
    path: decodes move to a live peer with token counts intact; crashes
    (no notice) fall back to resubmission."""

    name = "migrate"

    def on_evacuation_slot(self, system, inst, now, engine):
        # slots are uninterruptible: this runs at a slot boundary, the
        # one moment the instance's lists are not captured by an
        # in-flight completion event
        from repro_torch.core.mitosis import InstanceHandler
        for r in list(inst.pending):
            inst.remove_pending(r)
            _clear_chunk_progress(inst, r)
            self._resubmit(system, r, charge=False)
        targets = [i for i in system.instances
                   if i.alive and i.decode_here and i is not inst]
        tr = getattr(system, "transport", None)
        if tr is not None and tr.network is not None:
            targets = tr.filter_reachable(targets, now)
        for r in list(inst.decoding):
            if not targets:
                inst.remove_decoding(r)
                self._resubmit(system, r, charge=True)
                continue
            target = min(targets, key=lambda i: i.kv_tokens_used())
            if tr is not None and not tr.try_rpc(now, inst.iid, target.iid):
                # the handler round-trip failed on the degraded plane;
                # the request stays put — evacuation re-runs at the next
                # slot boundary and the notice deadline bounds the wait
                continue
            # the paper's <100 ms logical migration: the serialized proxy
            # crosses the scheduler boundary, not the instance state
            handler = InstanceHandler.for_instance(target)
            resolved = InstanceHandler.deserialize(
                handler.serialize()).resolve()
            inst.remove_decoding(r)
            r.instance_id = resolved.iid
            resolved.add_decoding(r)
            system.fault_stats["migrated"] += 1
            trc = getattr(system, "tracer", NULL_TRACER)
            if trc.enabled:
                trc.migrate(now, r.rid, inst.iid, resolved.iid)
            if engine is not None:
                engine.activate(resolved)
        if not inst.pending and not inst.decoding:
            system._evacuating.pop(inst.iid, None)

    def on_planned_removal(self, system, inst, now, engine):
        # evacuate at the next slot boundary instead of draining; with no
        # engine driving slots (bare scale_down in tests) this is a
        # drain-in-place no-op, same as the default
        system._evacuating[inst.iid] = float("inf")


def _clear_chunk_progress(inst: Instance, req: Request) -> None:
    """Forget partial chunked-prefill progress for a request leaving the
    instance (EcoServe-CP ``_chunk_progress`` / Sarathi ``_progress``):
    its KV prefix lives on this instance only, so a re-admission
    elsewhere restarts the prefill from scratch."""
    for attr in ("_chunk_progress", "_progress"):
        d = getattr(inst, attr, None)
        if d is not None:
            d.pop(req.rid, None)


# --------------------------------------------------------------------- #
# declarative construction (same shape as repro_torch.core.policies)
# --------------------------------------------------------------------- #

FAILURE_POLICIES = {
    DropFailure.name: DropFailure,
    ResubmitFailure.name: ResubmitFailure,
    MigrateFailure.name: MigrateFailure,
}


def make_failure_policy(
        spec: Union[str, FailurePolicy]) -> FailurePolicy:
    """``"drop"`` / ``"resubmit[:K]"`` / ``"migrate[:K]"`` (``:K`` is the
    retry budget) or an instance (passed through)."""
    if isinstance(spec, FailurePolicy):
        return spec
    if isinstance(spec, str):
        name, _, arg = spec.partition(":")
        if name not in FAILURE_POLICIES:
            raise KeyError(f"unknown failure policy {name!r}; expected "
                           f"one of {tuple(FAILURE_POLICIES)}")
        cls = FAILURE_POLICIES[name]
        return cls(float(arg)) if arg else cls()
    raise TypeError(f"cannot build a failure policy from {spec!r}")
