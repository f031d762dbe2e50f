"""Fault injection through the engine's event loop.

``FaultInjector.attach`` pushes one engine event per scheduled fault;
at fire time the event resolves its victim against the live pool and
calls the system's fault hooks (``fault_crash`` / ``fault_preempt``) or
installs a slowdown wrapper.  Everything runs in sim-time on the shared
event heap — injection order against arrivals and completions is the
deterministic heap order, so faulted cells reproduce bit-exactly across
worker counts.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.instance import ExecutorModel, Instance
from repro_torch.faults.network import NETWORK_KINDS, NetworkModel
from repro_torch.faults.schedule import (FaultEvent, FaultSchedule,
                                   _schedule_seed)


class SlowExecutor:
    """Straggler wrapper: every predicted duration is multiplied by
    ``factor``.  The scheduler-side cost model (``predict_prefill`` on
    the macro scheduler) is untouched — the control plane does not know
    the instance degraded, exactly like a real slow node."""

    def __init__(self, inner: ExecutorModel, factor: float):
        self.inner = inner
        self.factor = factor
        # preserve the engine's O(1) summed-context fast path marker
        if hasattr(inner, "ctx_clamp"):
            self.ctx_clamp = inner.ctx_clamp

    def prefill_time(self, lens):
        return self.factor * self.inner.prefill_time(lens)

    def decode_time(self, *args, **kw):
        return self.factor * self.inner.decode_time(*args, **kw)

    def hybrid_time(self, *args, **kw):
        return self.factor * self.inner.hybrid_time(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FaultInjector:
    """Binds a ``FaultSchedule`` to a live (system, engine) pair."""

    def __init__(self, schedule: FaultSchedule, system):
        self.schedule = schedule
        self.system = system
        self.log: List[Dict] = []

    def attach(self, engine) -> "FaultInjector":
        if any(ev.kind in NETWORK_KINDS for ev in self.schedule.events):
            # the schedule carries network clauses: build the degradation
            # plane up front (seeded exactly like the schedule itself) so
            # every transfer from t=0 routes through the degraded path
            transport = getattr(self.system, "transport", None)
            if transport is not None and transport.network is None:
                transport.attach_network(NetworkModel(
                    _schedule_seed(self.schedule.spec,
                                   self.schedule.seed)))
        for ev in self.schedule.events:
            engine.push_call(ev.t, self._fire, ev, engine)
        return self

    # ------------------------------------------------------------------ #
    def _fire(self, ev: FaultEvent, engine) -> None:
        system = self.system
        live = [i for i in system.instances if i.alive]
        entry: Dict = {"t": round(engine.now, 6), "kind": ev.kind}
        if ev.kind in NETWORK_KINDS:
            self._fire_network(ev, engine, live, entry)
            self.log.append(entry)
            trc = engine.tracer
            if trc.enabled and "skipped" not in entry:
                trc.fault(engine.now, ev.kind, entry.get("iid"))
            return
        if ev.kind == "slow":
            victims = [i for i in live
                       if not isinstance(i.executor, SlowExecutor)]
            if not victims:
                entry["skipped"] = "no-victim"
                self.log.append(entry)
                return
            victim = victims[int(ev.pick * len(victims))]
            victim.set_executor(SlowExecutor(victim.executor, ev.factor))
            engine.push_call(engine.now + ev.duration,
                             self._end_slow, victim)
            # composite systems (repro_torch.fleet) aggregate fault_stats from
            # their member pools: charge the stat to the victim's owner
            owner = system.owner_of(victim) \
                if hasattr(system, "owner_of") else system
            owner.fault_stats["slowdowns"] += 1
            entry.update(iid=victim.iid, factor=ev.factor,
                         dur=ev.duration)
        else:
            if len(live) <= 1:
                # never take the whole pool down: a zero-instance system
                # can only report vacuous metrics
                entry["skipped"] = "last-instance"
                self.log.append(entry)
                return
            victim = live[int(ev.pick * len(live))]
            entry["iid"] = victim.iid
            if ev.kind == "crash":
                lost = system.fault_crash(victim, engine.now, engine)
                entry["lost"] = len(lost)
            else:
                system.fault_preempt(victim, ev.notice, engine.now,
                                     engine)
                entry["notice"] = ev.notice
        self.log.append(entry)
        trc = engine.tracer
        if trc.enabled and "skipped" not in entry:
            trc.fault(engine.now, ev.kind, entry.get("iid"))

    def _fire_network(self, ev: FaultEvent, engine, live: List[Instance],
                      entry: Dict) -> None:
        """Toggle a degradation episode on the system transport's
        network plane (``duration == 0`` means until the end of the
        run).  Network events never touch ``fault_stats`` — the
        transport keeps its own counters — so instance-fault goldens
        keep their exact key sets."""
        transport = getattr(self.system, "transport", None)
        net = getattr(transport, "network", None)
        if net is None:
            entry["skipped"] = "no-transport"
            return
        if ev.kind == "partition":
            if not live:
                entry["skipped"] = "no-victim"
                return
            victim = live[int(ev.pick * len(live))]
            net.begin_partition(victim.iid)
            engine.push_call(engine.now + ev.duration,
                             net.end_partition, victim.iid)
            entry.update(iid=victim.iid, dur=ev.duration)
            return
        net.apply(ev.kind, ev.factor)
        entry["value"] = ev.factor
        if ev.duration > 0.0:
            engine.push_call(engine.now + ev.duration,
                             net.revert, ev.kind, ev.factor)
            entry["dur"] = ev.duration

    @staticmethod
    def _end_slow(victim: Instance) -> None:
        if isinstance(victim.executor, SlowExecutor):
            victim.set_executor(victim.executor.inner)

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict:
        """JSON-safe digest for result rows (pinned by the fault-scenario
        golden): the schedule identity, what actually fired, and the
        system's fault accounting."""
        applied: Dict[str, int] = {}
        for e in self.log:
            if "skipped" not in e:
                applied[e["kind"]] = applied.get(e["kind"], 0) + 1
        out = {
            "spec": self.schedule.spec,
            "n_scheduled": len(self.schedule.events),
            "applied": applied,
            "n_skipped": sum(1 for e in self.log if "skipped" in e),
            "log": self.log,
            "stats": dict(self.system.fault_stats),
        }
        transport = getattr(self.system, "transport", None)
        if transport is not None and transport.network is not None:
            # only when the schedule engaged the network plane: rows of
            # instance-fault-only cells keep their pre-transport shape
            out["transport"] = transport.summary()
        return out
