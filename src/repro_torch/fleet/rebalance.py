"""Budget-constrained fleet rebalancing: scaling as *moving* capacity.

The PR 5 control plane scales one pool against an unbounded machine
supply; a fleet shares a fixed GPU budget, so growth must usually be
funded by shrinking someone else.  ``FleetRebalanceHarness`` runs one
``SignalCollector`` + ``TargetBandController`` + ``Actuator`` triple
per pool (min_instances=1, max capped by the budget) off a single
engine tick, and reconciles their per-pool wishes under the budget:

1. **repair** — capacity lost to faults is re-provisioned toward each
   pool's last committed intent first (the PR 6 contract);
2. **downs** — pools whose controller asked to shrink release budget
   (refused contractions roll the controller's cooldown back);
3. **ups** — pools asking to grow are served in pressure order
   (backlog per committed instance, then pool index).  A grow fits
   inside free budget when there is any; otherwise a **donor-funded
   move**: the calmest eligible donor — not asking to grow itself,
   above one instance, backlog at or under the controller's
   ``queue_low`` band, and freeing enough devices — is contracted and
   the receiver commissioned in the same tick, provisioning delay and
   all.  No eligible donor means the grow waits.

Invariants, enforced structurally and pinned by tests: committed
devices (live + provisioning, priced per pool) never exceed the
budget, and no pool's committed count drops below one instance.
Decisions, signals, and timelines are pure sim-time bookkeeping —
fleet cells stay bit-reproducible across worker counts.

Completions are dispatched to per-pool collectors through the fleet's
``pool_of_rid`` record (the engine's ``finished`` list is global), and
arrivals through the fleet's ``on_route`` tap, so each pool's
controller sees only its own traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.control import (Actuator, ControllerConfig, ScalingTimeline,
                           SignalCollector, TargetBandController,
                           make_controller)


def _rebalance_config(control) -> ControllerConfig:
    """``"rebalance"`` or ``"rebalance:interval=1,target=0.92"`` — the
    options ride the band controller's parser so both spell knobs the
    same way."""
    name, _, args = str(control).partition(":")
    if name != "rebalance":
        raise KeyError(f"unknown fleet control spec {control!r}; "
                       "expected 'rebalance[:k=v,...]'")
    proto = make_controller("band" + (f":{args}" if args else ""))
    return proto.config


class _FleetTimeline:
    """Duck-types the single-pool ``ScalingTimeline`` for ``run_once``:
    ``summary()`` nests per-pool timelines under the pool names plus the
    fleet-level move accounting."""

    def __init__(self, harness: "FleetRebalanceHarness"):
        self._h = harness

    def summary(self) -> Dict[str, Any]:
        h = self._h
        return {
            "budget": h.fleet.budget,
            "n_moves": h.n_moves,
            "n_ups": h.n_ups,
            "n_downs": h.n_downs,
            "n_repairs": h.n_repairs,
            "per_pool": {name: tl.summary()
                         for name, tl in zip(h.fleet.pool_names,
                                             h.timelines)},
        }


class FleetRebalanceHarness:
    """Closed loop over a live (fleet, engine) pair under one budget."""

    def __init__(self, fleet, engine, control="rebalance"):
        self.fleet = fleet
        self.engine = engine
        base = _rebalance_config(control)
        self.interval = base.interval
        self.collectors: List[SignalCollector] = []
        self.controllers: List[TargetBandController] = []
        self.actuators: List[Actuator] = []
        self.timelines: List[ScalingTimeline] = []
        for pool in fleet.pools:
            cap = max(1, fleet.budget // pool.cost.devices)
            cfg = dataclasses.replace(base, min_instances=1,
                                      max_instances=cap)
            tl = ScalingTimeline()
            self.collectors.append(SignalCollector(
                pool.slo_set or fleet.slo_set,
                window=max(5.0, 4 * cfg.interval)))
            self.controllers.append(TargetBandController(cfg))
            self.actuators.append(Actuator(pool, engine, cfg, tl))
            self.timelines.append(tl)
        self.timeline = _FleetTimeline(self)
        self._finished_by_pool: List[List] = [[] for _ in fleet.pools]
        self._n_seen = 0              # prefix of engine.finished dispatched
        self._next_tick = self.interval
        self.n_moves = 0
        self.n_ups = 0
        self.n_downs = 0
        self.n_repairs = 0

    # ---------------- wiring ------------------------------------------- #
    def attach(self) -> "FleetRebalanceHarness":
        def on_route(k: int, req, now: float) -> None:
            self.collectors[k].on_arrival(req, now)

        self.fleet.on_route = on_route
        prev_tick = self.engine.on_tick

        def on_tick(now: float):
            if prev_tick is not None:
                prev_tick(now)
            self._maybe_control(now)

        self.engine.on_tick = on_tick
        return self

    # ---------------- per-tick control --------------------------------- #
    def _dispatch_finished(self) -> None:
        """Route engine completions to the owning pool's append-only
        list (each collector keeps its own consumed-prefix cursor)."""
        finished = self.engine.finished
        for r in finished[self._n_seen:]:
            k = self.fleet.pool_of_rid.get(r.rid)
            if k is not None:
                self._finished_by_pool[k].append(r)
        self._n_seen = len(finished)

    def _signals(self, k: int, now: float) -> Dict[str, float]:
        pool = self.fleet.pools[k]
        col = self.collectors[k]
        col.consume_finished(self._finished_by_pool[k], now)
        return {
            "t": now,
            "rate_ewma": col.rate_ewma(now),
            "queue_depth": float(SignalCollector.queue_depth(pool)),
            "kv_occupancy": SignalCollector.kv_occupancy(pool),
            "attainment_window": col.attainment_window(),
            "arrivals_total": float(col._arrivals),
            "n_instances": float(len(pool.instances)),
        }

    def _maybe_control(self, now: float) -> None:
        if now < self._next_tick:
            return
        self._dispatch_finished()
        sigs = [self._signals(k, now) for k in range(len(self.fleet.pools))]
        for k, act in enumerate(self.actuators):
            self.n_repairs += act.repair(now, sigs[k])
        wants = [self.controllers[k].decide(sigs[k],
                                            self.actuators[k].n_target)
                 for k in range(len(self.fleet.pools))]
        self._reconcile(wants, now, sigs)
        for k, act in enumerate(self.actuators):
            act.note_intent(act.n_target)
            self.timelines[k].record_tick(
                now, len(self.fleet.pools[k].instances), act.n_target)
        self._next_tick = now + self.interval

    # ---------------- budget arithmetic -------------------------------- #
    def committed_devices(self) -> int:
        """GPUs committed fleet-wide: live + provisioning, priced by
        each pool's per-instance device count."""
        return sum(act.n_target * pool.cost.devices
                   for act, pool in zip(self.actuators, self.fleet.pools))

    def _queue_per_target(self, k: int, sigs) -> float:
        return sigs[k]["queue_depth"] / max(1, self.actuators[k].n_target)

    def _pick_donor(self, receiver: int, wants: List[int], sigs,
                    need: int) -> Optional[int]:
        """Calmest pool that can fund the receiver's grow: not asking to
        grow itself, above one committed instance, backlog at or under
        the band's ``queue_low``, and whose per-instance device count
        covers the shortfall.  Deterministic: lowest backlog, then pool
        index."""
        free = self.fleet.budget - self.committed_devices()
        candidates = []
        for j in range(len(self.fleet.pools)):
            if j == receiver or wants[j] > 0:
                continue
            if self.actuators[j].n_target <= 1:
                continue
            cfg = self.controllers[j].config
            if self._queue_per_target(j, sigs) > cfg.queue_low:
                continue
            if free + self.fleet.pools[j].cost.devices < need:
                continue            # the donation would not fit the grow
            candidates.append(j)
        if not candidates:
            return None
        return min(candidates,
                   key=lambda j: (self._queue_per_target(j, sigs), j))

    def _reconcile(self, wants: List[int], now: float, sigs) -> None:
        # 1. voluntary contractions release budget first
        for k, w in enumerate(wants):
            if w < 0:
                if self.actuators[k].n_target <= 1:
                    # structural floor: never empty a pool, whatever the
                    # per-pool controller asked for
                    self.controllers[k].on_down_refused()
                elif self.actuators[k].apply(-1, now, sigs[k]):
                    self.n_downs += 1
                else:
                    self.controllers[k].on_down_refused()
        # 2. expansions in pressure order (worst backlog per committed
        #    instance first; pool index breaks ties)
        ups = sorted((k for k, w in enumerate(wants) if w > 0),
                     key=lambda k: (-self._queue_per_target(k, sigs), k))
        for k in ups:
            need = self.fleet.pools[k].cost.devices
            if self.committed_devices() + need <= self.fleet.budget:
                self.actuators[k].apply(+1, now, sigs[k])
                self.n_ups += 1
                continue
            donor = self._pick_donor(k, wants, sigs, need)
            if donor is None:
                # nobody can safely fund it: the grow waits (the
                # controller's up-cooldown spaces out re-asks)
                continue
            if not self.actuators[donor].apply(-1, now, sigs[donor]):
                # the donor pool refused (e.g. a FuDG base protecting
                # its last decoder): nothing moved
                self.controllers[donor].on_down_refused()
                continue
            if self.committed_devices() + need <= self.fleet.budget:
                self.actuators[k].apply(+1, now, sigs[k])
                self.n_moves += 1

    # ---------------- reporting ---------------------------------------- #
    def summary(self) -> Dict[str, Any]:
        return self.timeline.summary()
