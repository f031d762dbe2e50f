"""Actuation: applying scale decisions through the serving system's
mitosis machinery, with a modeled provisioning delay.

``Actuator.apply`` turns a controller decision into real pool changes:

* **expand** — a new instance is *committed* immediately (the controller
  sees it in ``n_target`` so it cannot double-scale while provisioning)
  but only joins the pool ``provision_delay`` sim-seconds later, via an
  engine event that calls ``system.scale_up`` — which routes through the
  existing machinery (for EcoServe: ``RoutingPolicy.add_instance`` ->
  ``OverallScheduler.add_instance``, i.e. mitosis expansion/split,
  Fig. 7) and immediately retries the waiting queue against the new
  capacity;
* **contract** — ``system.scale_down`` runs at decision time (for
  EcoServe: ``OverallScheduler.remove_instance``, the Fig. 7
  contraction/merge path); the retired instance drains its in-flight
  work but receives no new requests, so no delay is modeled.

Every decision is recorded in a ``ScalingTimeline`` — (decision time,
effective time, direction, pool sizes, triggering signals) plus the
per-tick ``(t, n_live, n_target)`` trajectory — whose ``summary()`` is
JSON-safe and rides on result rows for the dynamic-scaling golden.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.control.controller import ControllerConfig, ScalingController
from repro_torch.control.signals import SignalCollector


@dataclasses.dataclass
class ScalingEvent:
    t_decision: float
    t_effective: float
    action: str                     # "up" | "down" | "repair"
    n_before: int                   # live instances at decision time
    n_target: int                   # committed count after the decision
    queue_depth: float
    attainment_window: Optional[float]


@dataclasses.dataclass
class ScalingTimeline:
    events: List[ScalingEvent] = dataclasses.field(default_factory=list)
    trajectory: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)

    def record_tick(self, now: float, n_live: int, n_target: int) -> None:
        self.trajectory.append(
            {"t": round(now, 6), "n": n_live, "n_target": n_target})

    def mean_instances(self, t0: float, t1: float) -> float:
        """Time-weighted mean live-instance count over [t0, t1].

        The trajectory is piecewise constant between control ticks; the
        value entering the window comes from the last tick at/before
        ``t0`` (the pool size does not reset at a window edge) and the
        final segment is carried to ``t1``, so the divisor is the full
        window, not just the inter-tick sub-span."""
        if t1 <= t0 or not self.trajectory:
            return 0.0
        # value in force at t0: last point at/before it, else the first
        # recorded value (the pool existed before the first tick too)
        current = self.trajectory[0]["n"]
        for p in self.trajectory:
            if p["t"] > t0:
                break
            current = p["n"]
        area, t = 0.0, t0
        for p in self.trajectory:
            if p["t"] <= t0:
                continue
            if p["t"] >= t1:
                break
            area += (p["t"] - t) * current
            t, current = p["t"], p["n"]
        area += (t1 - t) * current
        return area / (t1 - t0)

    def summary(self) -> Dict[str, Any]:
        """JSON-safe digest for result rows (the full trajectory is kept:
        the dynamic-scaling golden pins it bit-exactly)."""
        ns = [p["n"] for p in self.trajectory]
        return {
            "events": [{
                "t_decision": round(e.t_decision, 6),
                "t_effective": round(e.t_effective, 6),
                "action": e.action,
                "n_before": e.n_before,
                "n_target": e.n_target,
            } for e in self.events],
            "n_scale_ups": sum(1 for e in self.events
                               if e.action == "up"),
            "n_scale_downs": sum(1 for e in self.events
                                 if e.action == "down"),
            "n_min": min(ns) if ns else 0,
            "n_max": max(ns) if ns else 0,
            "n_final": ns[-1] if ns else 0,
            "trajectory": self.trajectory,
        }


class Actuator:
    """Applies controller decisions to a live (system, engine) pair."""

    def __init__(self, system, engine,
                 config: ControllerConfig, timeline: ScalingTimeline):
        self.system = system
        self.engine = engine
        self.config = config
        self.timeline = timeline
        self._provisioning = 0      # committed, not yet live
        self._cancelled = 0         # pending commissions revoked by "down"
        self._intent: Optional[int] = None   # controller's last target

    @property
    def n_target(self) -> int:
        return len(self.system.instances) + self._provisioning

    def apply(self, decision: int, now: float,
              signals: Dict[str, float]) -> bool:
        """Apply a decision; returns False when the system refused it
        (only contraction can be refused) so the caller can roll the
        controller's cooldown state back."""
        if decision == 0:
            return True
        n_live = len(self.system.instances)
        if decision > 0:
            self._provisioning += 1
            t_eff = now + self.config.provision_delay
            self.engine.push_call(t_eff, self._commission)
            self.timeline.events.append(ScalingEvent(
                t_decision=now, t_effective=t_eff, action="up",
                n_before=n_live, n_target=self.n_target,
                queue_depth=signals["queue_depth"],
                attainment_window=signals["attainment_window"]))
            return True
        if self._provisioning > 0:
            # a commission is still in flight: revoke it instead of
            # shrinking the live pool — otherwise the provisioning
            # instance joins anyway and the pool overshoots the target
            self._provisioning -= 1
            self._cancelled += 1
            self.timeline.events.append(ScalingEvent(
                t_decision=now, t_effective=now, action="down",
                n_before=n_live, n_target=self.n_target,
                queue_depth=signals["queue_depth"],
                attainment_window=signals["attainment_window"]))
            return True
        gone = self.system.scale_down(now, self.engine)
        if gone is None:            # routing refused (e.g. last decoder)
            return False
        self.timeline.events.append(ScalingEvent(
            t_decision=now, t_effective=now, action="down",
            n_before=n_live, n_target=self.n_target,
            queue_depth=signals["queue_depth"],
            attainment_window=signals["attainment_window"]))
        return True

    def note_intent(self, n: int) -> None:
        """Record the controller's committed pool size after a decision;
        ``repair`` re-provisions toward it when faults destroy capacity."""
        self._intent = n

    def repair(self, now: float, signals: Dict[str, float]) -> int:
        """Re-provision capacity lost to faults: when ``n_target`` has
        dropped *below* the controller's last committed intent — which
        only happens when instances died outside the control loop
        (crash/preemption), never from its own decisions — commission
        replacements.  Returns the number started."""
        if self._intent is None:
            return 0
        started = 0
        while self._intent - self.n_target > 0:
            self._provisioning += 1
            t_eff = now + self.config.provision_delay
            self.engine.push_call(t_eff, self._commission)
            self.timeline.events.append(ScalingEvent(
                t_decision=now, t_effective=t_eff, action="repair",
                n_before=len(self.system.instances),
                n_target=self.n_target,
                queue_depth=signals["queue_depth"],
                attainment_window=signals["attainment_window"]))
            started += 1
        return started

    def _commission(self) -> None:
        """Provisioning finished: the instance joins the pool and the
        waiting queue is retried against the new capacity."""
        if self._cancelled > 0:     # revoked by a later "down" decision
            self._cancelled -= 1
            return
        self._provisioning -= 1
        inst = self.system.scale_up(self.engine)
        trc = self.engine.tracer
        if trc.enabled:
            trc.control(self.engine.now, "commission",
                        getattr(inst, "iid", None))
        self.system._drain_queue(self.engine.now, self.engine)


class ControlLoopHarness:
    """Closed loop over a live simulation: taps arrivals via a ``submit``
    wrapper, samples signals every ``interval`` sim-seconds off the
    engine's tick callback, and actuates decisions.

    Install with ``attach``; the harness chains any pre-existing
    ``on_tick`` so callers that already observe the engine keep working.
    """

    def __init__(self, system, engine, controller: ScalingController,
                 collector: Optional[SignalCollector] = None):
        self.system = system
        self.engine = engine
        self.controller = controller
        cfg = controller.config
        self.collector = collector or SignalCollector(
            system.slo_set, window=max(5.0, 4 * cfg.interval))
        self.timeline = ScalingTimeline()
        self.actuator = Actuator(system, engine, cfg, self.timeline)
        self._next_tick = cfg.interval
        # last signal snapshot DELIVERED over the telemetry channel; on
        # a clean plane every snapshot arrives instantly, under network
        # faults snapshots may arrive late or not at all and the
        # controller decides on this (possibly stale) reading
        self._inbox: Optional[Dict[str, float]] = None

    def attach(self) -> "ControlLoopHarness":
        orig_submit = self.system.submit

        def submit(req, now, engine):
            self.collector.on_arrival(req, now)
            orig_submit(req, now, engine)

        self.system.submit = submit
        prev_tick = self.engine.on_tick

        def on_tick(now: float):
            if prev_tick is not None:
                prev_tick(now)
            self._maybe_control(now)

        self.engine.on_tick = on_tick
        return self

    def _maybe_control(self, now: float) -> None:
        # at most one decision per control period, evaluated at the time
        # of the first event past the period boundary — signals always
        # describe the system state that actually exists at ``now``, and
        # commissioned instances always land strictly in the future
        if now < self._next_tick:
            return
        snap = self.collector.snapshot(self.system, self.engine, now)
        trc = self.engine.tracer
        if trc.enabled:
            trc.control(now, "snapshot", round(snap.get("queue_depth",
                                                        0.0), 6))
        transport = getattr(self.system, "transport", None)
        if transport is not None and transport.network is not None:
            # telemetry crosses the degraded plane: the snapshot may be
            # dropped (the controller keeps deciding on its last
            # delivered one) or arrive a network delay late
            fate, d = transport.snapshot_channel(now)
            if fate == "ok":
                self._inbox = snap
            elif fate == "delay":
                self.engine.push_call(now + d, self._receive_snapshot,
                                      snap)
        else:
            self._inbox = snap
        if self._inbox is None:
            # nothing ever arrived (first snapshots all lost): no basis
            # to decide on, but the tick cadence must not stall
            self.timeline.record_tick(now, len(self.system.instances),
                                      self.actuator.n_target)
            self._next_tick = now + self.controller.config.interval
            return
        signals = dict(self._inbox)
        signals["stale"] = now - self._inbox["t"]
        # replace capacity lost to faults first (n_target below the last
        # committed intent) so the controller decides against the pool it
        # actually asked for; a no-op in fault-free runs
        self.actuator.repair(now, signals)
        decision = self.controller.decide(signals, self.actuator.n_target)
        if trc.enabled:
            trc.control(now, "decision", decision)
        if not self.actuator.apply(decision, now, signals):
            # contraction refused: the pool did not change, so the
            # controller must not sit out a cooldown for it
            self.controller.on_down_refused()
        self.actuator.note_intent(self.actuator.n_target)
        self.timeline.record_tick(now, len(self.system.instances),
                                  self.actuator.n_target)
        self._next_tick = now + self.controller.config.interval

    def _receive_snapshot(self, snap: Dict[str, float]) -> None:
        """A delayed telemetry snapshot finally arrived; keep the newest
        reading (a slower older one must not overwrite a fresher one)."""
        if self._inbox is None or snap["t"] >= self._inbox["t"]:
            self._inbox = snap
