"""Transport: every cross-instance / cross-plane interaction as an
explicit, failable message.

``PolicySystemBase`` owns one ``Transport``; the FuDG KV hand-off hooks,
the ``migrate:K`` evacuation RPCs, and the control loop's signal
snapshots all route through it.  With no network plane attached
(``network is None`` — every fault-free or instance-fault-only cell) the
transport is *ideal*: transfers take exactly what their ``Link`` says
and RPCs/snapshots succeed instantly, reproducing the pre-transport
event timeline bit-exactly.  Attaching a ``NetworkModel``
(``repro_torch.faults.network``, built by the fault injector from ``netdelay``
/ ``netloss`` / ``netdegrade`` / ``partition`` clauses) turns on the
degradation path:

* **transfers** — delivery time adds the plane's extra latency and
  divides the link bandwidth by its degradation factor; each message
  may be *lost* (loss draw, or either endpoint partitioned), in which
  case the sender notices only at a per-call timeout and retries with
  exponential backoff + deterministic jitter up to a retry budget;
* **per-link circuit breaker** — consecutive failures on one
  (src, dst) pair open the breaker for a cooldown, turning further
  sends into fast-fails (no timeout wait) and marking the destination
  unreachable to the routing layer;
* **RPCs** — the synchronous coordination path (handler round-trips at
  evacuation slots): a bounded number of loss draws decides success;
  failures trip the same breaker;
* **snapshots** — control-plane telemetry may be dropped (the
  controller holds its last decision via the staleness guard) or
  arrive one network delay late.

Everything is pure sim-time and deterministic: the only randomness is
the ``NetworkModel``'s counter-keyed hash draws, seeded from
CRC32(spec) ^ cell-seed exactly like the fault schedule, so transport
logs reproduce bit-exactly across runs and worker counts.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.events import NULL_TRACER

POOL = -2            # MoonCake's centralized KV pool endpoint
CTRL = -1            # the coordination plane (scheduler / controller)

# per-(src,dst)-link counter template: which fates a single link can see
_LINK_KEYS = ("sent", "delivered", "lost", "retries", "timeouts",
              "breaker_opens")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Retry/timeout knobs for the degraded path (documented in
    benchmarks/README.md; the ideal path never reads them)."""

    timeout_factor: float = 3.0   # per-call timeout = factor x nominal time
    min_timeout: float = 0.050    # timeout floor (s)
    retries: int = 3              # retry budget per message (attempts - 1)
    backoff_base: float = 0.040   # first backoff (s); doubles per attempt
    backoff_cap: float = 1.0      # backoff ceiling (s)
    jitter: float = 0.5           # +/- fraction, deterministic hash draw
    rpc_latency: float = 1e-3     # nominal one-way latency of a bare RPC
    breaker_threshold: int = 3    # consecutive failures that open a link
    breaker_cooldown: float = 4.0 # seconds a tripped breaker stays open


class CircuitBreaker:
    """Per-link consecutive-failure breaker with a cooldown half-open:
    after the cooldown the next call is allowed through and its outcome
    re-closes or re-opens the circuit."""

    __slots__ = ("threshold", "cooldown", "fails", "open_until", "opens")

    def __init__(self, threshold: int, cooldown: float):
        self.threshold = threshold
        self.cooldown = cooldown
        self.fails = 0
        self.open_until = float("-inf")
        self.opens = 0

    def allow(self, now: float) -> bool:
        return now >= self.open_until

    def record_ok(self) -> None:
        self.fails = 0
        self.open_until = float("-inf")

    def record_fail(self, now: float) -> bool:
        """Count a failure; returns True when this one opened the
        circuit."""
        self.fails += 1
        if self.fails >= self.threshold:
            self.open_until = now + self.cooldown
            self.fails = 0
            self.opens += 1
            return True
        return False


class Transport:
    """The message plane between instances and the coordination plane."""

    # flight-recorder hook (repro_torch.obs.attach_tracer)
    tracer = NULL_TRACER

    def __init__(self, config: Optional[TransportConfig] = None):
        self.config = config or TransportConfig()
        # None = ideal links (the default); the fault injector attaches a
        # NetworkModel when the schedule carries network clauses
        self.network = None
        self._breakers: Dict[Tuple[int, int], CircuitBreaker] = {}
        self._dst_open: Dict[int, float] = {}   # dst -> breaker open_until
        self._msg_ids = itertools.count()
        self.log: List[Dict[str, Any]] = []
        self.stats: Dict[str, int] = {
            "sent": 0, "delivered": 0, "lost": 0, "retries": 0,
            "timeouts": 0, "breaker_opens": 0, "breaker_fastfails": 0,
            "rpc_calls": 0, "rpc_retries": 0, "rpc_failures": 0,
            "snapshots_dropped": 0, "snapshots_delayed": 0,
        }
        # per-(src,dst) message fates; populated only on the degraded
        # path (mirrors ``stats``), so clean cells report no links
        self.link_stats: Dict[Tuple[int, int], Dict[str, int]] = {}

    def _link(self, src: int, dst: int) -> Dict[str, int]:
        ls = self.link_stats.get((src, dst))
        if ls is None:
            ls = self.link_stats[(src, dst)] = dict.fromkeys(_LINK_KEYS, 0)
        return ls

    # ---------------- plane attachment / reachability ------------------- #
    def attach_network(self, network) -> None:
        """Install the degradation plane (idempotent per run; the fault
        injector calls this once at attach time)."""
        self.network = network

    def instance_reachable(self, iid: int, now: float) -> bool:
        """Scheduler-side health view of an instance: not partitioned
        from the coordination plane and no open circuit toward it.  The
        routing layer (rolling activation, prefill dispatch, hand-off
        target choice) consults this to fail over instead of sending
        into a black hole."""
        net = self.network
        if net is None:
            return True
        if net.partitioned(iid):
            return False
        return now >= self._dst_open.get(iid, float("-inf"))

    def filter_reachable(self, instances, now: float):
        """Reachable subset of ``instances`` (the same list object when
        the plane is clean — zero cost on the default path)."""
        if self.network is None:
            return instances
        return [i for i in instances
                if self.instance_reachable(i.iid, now)]

    # ---------------- bulk transfers (FuDG KV hand-off) ----------------- #
    def transfer(self, engine, src: int, dst: int, nbytes: float,
                 now: float, deliver: Callable[[], None],
                 on_lost: Callable[[], None], link=None,
                 kind: str = "kv") -> None:
        """Move ``nbytes`` from ``src`` to ``dst`` over ``link`` and call
        ``deliver()`` at arrival — or ``on_lost()`` once the retry budget
        is exhausted.  The ideal path is byte-identical to the historic
        ``engine.push(link.transfer(...), deliver)``."""
        if self.network is None:
            done = link.transfer(nbytes, now) if link is not None else now
            engine.push(done, deliver)
            return
        mid = next(self._msg_ids)
        self.stats["sent"] += 1
        self._link(src, dst)["sent"] += 1
        trc = self.tracer
        if trc.enabled:
            trc.transport(now, "send", kind, src, dst)
        self._attempt(engine, mid, kind, src, dst, nbytes, now, now,
                      deliver, on_lost, link, 0)

    def _nominal(self, nbytes: float, link) -> float:
        """Unqueued clean-link time the *sender* expects — the basis of
        its per-call timeout (it knows the size and rated bandwidth, not
        the live congestion or degradation)."""
        if link is None:
            return self.config.rpc_latency
        return link.latency + nbytes / link.bandwidth

    def _attempt(self, engine, mid: int, kind: str, src: int, dst: int,
                 nbytes: float, t0: float, t: float, deliver, on_lost,
                 link, attempt: int) -> None:
        net, cfg = self.network, self.config
        breaker = self._breakers.get((src, dst))
        if breaker is None:
            breaker = CircuitBreaker(cfg.breaker_threshold,
                                     cfg.breaker_cooldown)
            self._breakers[(src, dst)] = breaker
        if not breaker.allow(t):
            # open circuit: fail fast, no timeout wait
            self.stats["breaker_fastfails"] += 1
            trc = self.tracer
            if trc.enabled:
                trc.transport(t, "fastfail", kind, src, dst)
            self._retry_or_lose(engine, mid, kind, src, dst, nbytes, t0,
                                t, deliver, on_lost, link, attempt)
            return
        lost = (net.partitioned(src) or net.partitioned(dst)
                or self._loss_draw(mid, attempt))
        if not lost:
            breaker.record_ok()
            done = link.transfer(nbytes, t, factor=net.degrade(),
                                 extra_latency=net.delay()) \
                if link is not None else t + net.delay()
            self.stats["delivered"] += 1
            self._link(src, dst)["delivered"] += 1
            self._log(mid, kind, src, dst, attempt + 1, "delivered",
                      t0, done)
            trc = self.tracer
            if trc.enabled:
                trc.transport(done, "deliver", kind, src, dst)
            engine.push(done, deliver)
            return
        # lost in flight: the sender only notices at its timeout
        timeout = max(cfg.min_timeout,
                      cfg.timeout_factor * self._nominal(nbytes, link))
        t_detect = t + timeout
        self.stats["timeouts"] += 1
        self._link(src, dst)["timeouts"] += 1
        trc = self.tracer
        if trc.enabled:
            trc.transport(t_detect, "timeout", kind, src, dst)
        if breaker.record_fail(t_detect):
            self.stats["breaker_opens"] += 1
            self._link(src, dst)["breaker_opens"] += 1
            if trc.enabled:
                trc.transport(t_detect, "breaker_open", kind, src, dst)
            self._dst_open[dst] = max(self._dst_open.get(dst, 0.0),
                                      breaker.open_until)
        engine.push_call(t_detect, self._retry_or_lose, engine, mid, kind,
                         src, dst, nbytes, t0, t_detect, deliver, on_lost,
                         link, attempt)

    def _retry_or_lose(self, engine, mid: int, kind: str, src: int,
                       dst: int, nbytes: float, t0: float, t: float,
                       deliver, on_lost, link, attempt: int) -> None:
        cfg = self.config
        trc = self.tracer
        if attempt >= cfg.retries:
            self.stats["lost"] += 1
            self._link(src, dst)["lost"] += 1
            self._log(mid, kind, src, dst, attempt + 1, "lost", t0, t)
            if trc.enabled:
                trc.transport(t, "lost", kind, src, dst)
            on_lost()
            return
        self.stats["retries"] += 1
        self._link(src, dst)["retries"] += 1
        if trc.enabled:
            trc.transport(t, "retry", kind, src, dst)
        backoff = min(cfg.backoff_cap, cfg.backoff_base * (2 ** attempt))
        jitter = (2.0 * self.network.draw("jit", mid, attempt) - 1.0)
        backoff *= 1.0 + cfg.jitter * jitter
        engine.push_call(t + backoff, self._attempt, engine, mid, kind,
                         src, dst, nbytes, t0, t + backoff, deliver,
                         on_lost, link, attempt + 1)

    def _loss_draw(self, mid: int, attempt: int) -> bool:
        p = self.network.loss()
        if p <= 0.0:
            return False
        return self.network.draw("loss", mid, attempt) < p

    def _log(self, mid, kind, src, dst, attempts, outcome, t0, t1):
        self.log.append({
            "id": mid, "kind": kind, "src": src, "dst": dst,
            "attempts": attempts, "outcome": outcome,
            "t0": round(t0, 6), "t1": round(t1, 6)})

    # ---------------- synchronous coordination RPCs --------------------- #
    def try_rpc(self, now: float, src: int, dst: int) -> bool:
        """One coordination round-trip (e.g. the ``InstanceHandler``
        serialize/resolve path at an evacuation slot).  The caller's own
        cadence is the outer retry loop — evacuations re-run every slot
        boundary until the notice deadline — so a failure here just means
        "not this slot"; internally a bounded number of loss draws models
        in-call retries.  Clean plane: always True, zero cost."""
        net = self.network
        if net is None:
            return True
        self.stats["rpc_calls"] += 1
        breaker = self._breakers.get((src, dst))
        if breaker is None:
            breaker = CircuitBreaker(self.config.breaker_threshold,
                                     self.config.breaker_cooldown)
            self._breakers[(src, dst)] = breaker
        if not breaker.allow(now):
            self.stats["breaker_fastfails"] += 1
            self.stats["rpc_failures"] += 1
            return False
        if net.partitioned(src) or net.partitioned(dst):
            self.stats["rpc_failures"] += 1
            trc = self.tracer
            if trc.enabled:
                trc.transport(now, "rpc_fail", "rpc", src, dst)
            if breaker.record_fail(now):
                self.stats["breaker_opens"] += 1
                self._link(src, dst)["breaker_opens"] += 1
                if trc.enabled:
                    trc.transport(now, "breaker_open", "rpc", src, dst)
                self._dst_open[dst] = max(self._dst_open.get(dst, 0.0),
                                          breaker.open_until)
            return False
        mid = next(self._msg_ids)
        p = net.loss()
        for attempt in range(self.config.retries + 1):
            if p <= 0.0 or net.draw("rpc", mid, attempt) >= p:
                if attempt:
                    self.stats["rpc_retries"] += attempt
                breaker.record_ok()
                return True
        self.stats["rpc_retries"] += self.config.retries
        self.stats["rpc_failures"] += 1
        trc = self.tracer
        if trc.enabled:
            trc.transport(now, "rpc_fail", "rpc", src, dst)
        if breaker.record_fail(now):
            self.stats["breaker_opens"] += 1
            self._link(src, dst)["breaker_opens"] += 1
            if trc.enabled:
                trc.transport(now, "breaker_open", "rpc", src, dst)
            self._dst_open[dst] = max(self._dst_open.get(dst, 0.0),
                                      breaker.open_until)
        return False

    # ---------------- control-plane telemetry --------------------------- #
    def snapshot_channel(self, now: float) -> Tuple[str, float]:
        """Fate of one controller signal snapshot crossing the plane:
        ``("ok", 0)`` delivered now, ``("delay", d)`` delivered ``d``
        seconds late, ``("drop", 0)`` lost (the harness keeps its last
        delivered snapshot and the controller's staleness guard holds)."""
        net = self.network
        if net is None:
            return ("ok", 0.0)
        mid = next(self._msg_ids)
        p = net.loss()
        if p > 0.0 and net.draw("snap", mid) < p:
            self.stats["snapshots_dropped"] += 1
            trc = self.tracer
            if trc.enabled:
                trc.transport(now, "snapshot_drop", "snapshot", CTRL, CTRL)
            return ("drop", 0.0)
        d = net.delay()
        if d > 0.0:
            self.stats["snapshots_delayed"] += 1
            trc = self.tracer
            if trc.enabled:
                trc.transport(now, "snapshot_delay", "snapshot", CTRL, CTRL)
            return ("delay", d)
        return ("ok", 0.0)

    # ---------------- accounting ---------------------------------------- #
    def summary(self) -> Dict[str, Any]:
        """JSON-safe counters for result rows (the per-message ``log``
        stays in-process: determinism tests compare it, goldens pin only
        these totals).  ``links`` breaks the totals down per
        (src, dst) pair — empty on a clean plane, since only the
        degraded path touches ``link_stats``."""
        out: Dict[str, Any] = dict(self.stats)
        out["links"] = {f"{src}->{dst}": dict(v)
                        for (src, dst), v in sorted(self.link_stats.items())}
        return out
