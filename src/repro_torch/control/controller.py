"""Scaling controllers: when to grow or shrink the instance pool.

Two policies, both emitting ``-1 | 0 | +1`` decisions per control tick:

* ``TargetBandController`` (the closed-loop default) — target-band logic
  with hysteresis and per-direction cooldowns.  Scale up when the
  sliding-window attainment falls below the SLO target or the
  per-instance queue backlog breaches the band's upper edge; scale down
  only when attainment sits above a *higher* water mark AND the queue is
  near-empty AND KV occupancy is low — the asymmetric thresholds are the
  hysteresis gap that keeps a constant-rate trace from flapping.  A
  breach must persist for ``hold`` consecutive ticks before the
  controller acts, and each action arms that direction's cooldown.
* ``ThresholdController`` (the trace-oblivious ablation baseline) —
  reacts to the *instantaneous* queue depth against fixed thresholds:
  no EWMA, no attainment window, no hold counter, no cooldown.  It
  exists to show what the hysteresis machinery buys.

Decisions are pure functions of (signals, controller state), both fully
deterministic, so autoscaled simulation cells stay bit-reproducible.

Controllers reason about ``n_target`` — the instance count *including*
still-provisioning additions the ``Actuator`` has in flight — so a
provisioning delay cannot be mistaken for an unanswered breach and
double-scaled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Shared knobs for both controller kinds (the threshold baseline
    reads only the subset it understands)."""

    interval: float = 2.0          # control period (sim-seconds)
    min_instances: int = 2
    max_instances: int = 8
    # target band (closed-loop controller)
    target_attainment: float = 0.9   # band floor: below this, scale up
    att_high: float = 0.98           # band ceiling: above this, may shrink
    att_safe: float = 0.97           # above this, a deep queue alone is
    #                                  NOT an up-breach (still in budget)
    queue_high: float = 8.0          # per-instance queued reqs forcing up
    queue_low: float = 4.0           # per-instance backlog allowing down
    kv_low: float = 0.5              # occupancy ceiling for scale-down
    # asymmetric hold: expansion answers a burst after one breaching
    # tick (under-capacity burns SLO immediately); contraction is the
    # risky direction, so it must see the calm persist
    hold_up: int = 1
    hold_down: int = 3
    cooldown_up: float = 4.0         # seconds after an expansion
    cooldown_down: float = 8.0       # seconds after a contraction
    # contraction-regret backoff: an expansion this soon after a
    # contraction means the shrink was wrong — double the effective
    # contraction cooldown (capped) so a rate with no stable pool size
    # inside the hysteresis band cannot sustain a limit cycle
    regret_window: float = 16.0
    regret_cap: float = 8.0          # max cooldown_down multiplier
    # staleness guard: with the telemetry channel degraded (network
    # faults dropping/delaying snapshots) a controller acting on a
    # reading older than this holds its last decision instead of
    # scaling on stale evidence
    staleness_limit: float = 6.0
    # threshold baseline
    threshold_up: float = 16.0       # absolute queue depth forcing up
    # actuation
    provision_delay: float = 1.5     # sim-seconds until a new instance
    #                                  starts taking traffic (modeled
    #                                  spin-up: weights load + warm-up)


class ScalingController:
    """Base: per-tick decide(); subclasses implement ``_decide``."""

    name = "controller"

    def __init__(self, config: ControllerConfig = None):
        self.config = config or ControllerConfig()
        self._last_up = -1e18
        self._last_down = -1e18
        self._breach_up = 0
        self._breach_down = 0
        self._down_penalty = 1.0     # contraction-regret multiplier

    def decide(self, signals: Dict[str, float], n_target: int) -> int:
        """-1 (contract), 0 (hold), or +1 (expand) — already clamped to
        the configured [min_instances, max_instances] pool bounds.
        Subclasses see the bounds too (via ``_can_up``/``_can_down``):
        a breach that CANNOT be acted on must not arm cooldowns, or a
        pool pinned at max would phantom-refresh its up-cooldown forever
        and never contract when the load passes."""
        d = self._decide(signals, n_target)
        if d > 0 and not self._can_up(n_target):
            return 0
        if d < 0 and not self._can_down(n_target):
            return 0
        return d

    def _can_up(self, n_target: int) -> bool:
        return n_target < self.config.max_instances

    def _can_down(self, n_target: int) -> bool:
        return n_target > self.config.min_instances

    def on_down_refused(self) -> None:
        """The actuator reports the system refused a contraction (e.g. a
        FuDG base protecting its last decoder): no instance was removed,
        so disarm the contraction cooldown — and with it the regret
        window — that ``_decide`` armed for a shrink that never
        happened.  Same contract as bound-clamped breaches: state must
        track what the pool actually did."""
        self._last_down = -1e18

    def _decide(self, signals: Dict[str, float], n_target: int) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class TargetBandController(ScalingController):
    """Closed-loop target band + hysteresis + per-direction cooldown."""

    name = "band"

    def _decide(self, signals, n_target):
        cfg = self.config
        if signals.get("stale", 0.0) > cfg.staleness_limit:
            # the snapshot is too old to act on (dropped/delayed
            # telemetry): hold the last decision — and do NOT arm the
            # breach counters off evidence that no longer describes the
            # pool
            return 0
        now = signals["t"]
        att = signals["attainment_window"]
        q_per_inst = signals["queue_depth"] / max(1, n_target)

        # a deep queue is an up-breach only while attainment is unknown
        # or already slipping: EcoServe's temporal disaggregation runs a
        # healthy prefill backlog by design, and a pool that is meeting
        # its SLO with room (att >= att_safe) is not under-provisioned
        breach_up = ((att is not None and att < cfg.target_attainment) or
                     (q_per_inst > cfg.queue_high and
                      (att is None or att < cfg.att_safe)))
        # contraction requires positive evidence of health: an unknown
        # attainment window (too few completions) blocks downs — acting
        # on "no data" is how pools get shredded during quiet starts
        breach_down = (att is not None and att >= cfg.att_high and
                       q_per_inst <= cfg.queue_low and
                       signals["kv_occupancy"] < cfg.kv_low)

        self._breach_up = self._breach_up + 1 if breach_up else 0
        self._breach_down = self._breach_down + 1 if breach_down else 0

        if (self._can_up(n_target) and
                self._breach_up >= cfg.hold_up and
                now - self._last_up >= cfg.cooldown_up):
            if now - self._last_down < cfg.regret_window:
                # the recent shrink is what we're now undoing: back off
                self._down_penalty = min(cfg.regret_cap,
                                         self._down_penalty * 2.0)
            self._last_up = now
            self._breach_up = 0
            self._breach_down = 0
            return +1
        if (self._can_down(n_target) and
                self._breach_down >= cfg.hold_down and
                now - self._last_down >= cfg.cooldown_down *
                self._down_penalty and
                now - self._last_up >= cfg.cooldown_up):
            self._last_down = now
            self._breach_down = 0
            return -1
        return 0


class ThresholdController(ScalingController):
    """Trace-oblivious ablation baseline: instantaneous queue depth vs
    fixed thresholds; no windowing, no hold, no cooldown."""

    name = "threshold"

    def _decide(self, signals, n_target):
        q = signals["queue_depth"]
        if q > self.config.threshold_up:
            return +1
        if q == 0 and signals["kv_occupancy"] < self.config.kv_low:
            return -1
        return 0


CONTROLLERS = {
    TargetBandController.name: TargetBandController,
    ThresholdController.name: ThresholdController,
}


def make_controller(spec, config: Optional[ControllerConfig] = None
                    ) -> ScalingController:
    """``"band"`` / ``"threshold"`` (optionally ``"band:max=12,delay=2"``
    style overrides: ``min``, ``max``, ``interval``, ``delay``, ``hold``)
    or a ``ScalingController`` instance passed through."""
    if isinstance(spec, ScalingController):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"cannot build a controller from {spec!r}")
    name, _, args = spec.partition(":")
    if name not in CONTROLLERS:
        raise KeyError(f"unknown controller {name!r}; expected one of "
                       f"{tuple(CONTROLLERS)}")
    cfg = config or ControllerConfig()
    if args:
        keymap = {"min": "min_instances", "max": "max_instances",
                  "interval": "interval", "delay": "provision_delay",
                  "hold": "hold_down", "target": "target_attainment"}
        updates = {}
        for kv in args.split(","):
            k, _, v = kv.partition("=")
            if k not in keymap or not v:
                raise KeyError(f"unknown controller option {kv!r}; "
                               f"expected k=v with k in {tuple(keymap)}")
            field = keymap[k]
            typ = int if field in ("min_instances", "max_instances",
                                   "hold_down") else float
            updates[field] = typ(v)
        cfg = dataclasses.replace(cfg, **updates)
    return CONTROLLERS[name](cfg)
