"""Windowed load signals for the autoscaling control plane.

``SignalCollector`` taps the two places load becomes observable in a
serving system — request arrivals (via a ``submit`` wrapper the harness
installs) and request completions (read incrementally off
``engine.finished``) — and folds them into the small set of signals the
``ScalingController`` consumes:

* ``rate_ewma`` — an event-driven exponentially-weighted arrival-rate
  estimate (each arrival bumps a decayed counter; no fixed bin edges, so
  the estimate is exact under any arrival pattern and fully
  deterministic given the event sequence);
* ``queue_depth`` — system-level waiting queue plus per-instance
  admitted-but-unprefilled backlog (requests, not tokens: the controller
  reasons in requests per instance);
* ``attainment_window`` — per-class SLO attainment over requests that
  *finished* in the trailing ``window`` seconds, reduced to the
  min-over-classes scalar (same worst-tenant discipline as the goodput
  search) — None until the first completion lands;
* ``kv_occupancy`` — aggregate KV-token utilization across instances.

Everything here is pure simulation-time bookkeeping: no wall clock, no
RNG, so a control loop driven by these signals is bit-reproducible.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.request import Request
from repro_torch.core.slo import SLOClassSet, request_meets_slo


class SignalCollector:
    """Folds arrival/completion events into the controller's signals."""

    def __init__(self, slo_set: SLOClassSet, window: float = 10.0,
                 ewma_tau: float = 8.0, min_samples: int = 8):
        assert window > 0 and ewma_tau > 0
        self.slo_set = slo_set
        self.window = window
        self.ewma_tau = ewma_tau
        self.min_samples = min_samples
        self._rate = 0.0               # decayed arrivals / tau
        self._rate_t = 0.0             # time of last EWMA update
        self._arrivals = 0
        # (finish_time, met_slo, slo_class) over the trailing window
        self._finished: Deque[Tuple[float, bool, str]] = deque()
        self._n_seen = 0               # prefix of engine.finished consumed

    # ---------------- event taps --------------------------------------- #
    def on_arrival(self, req: Request, now: float) -> None:
        self._decay_to(now)
        self._rate += 1.0 / self.ewma_tau
        self._arrivals += 1

    def consume_finished(self, finished: List[Request], now: float) -> None:
        """Fold completions the engine recorded since the last call into
        the sliding attainment window (incremental: ``engine.finished``
        is append-only)."""
        for r in finished[self._n_seen:]:
            met = request_meets_slo(r, self.slo_set.for_request(r))
            cls = r.slo_class if r.slo_class in self.slo_set.names \
                else self.slo_set.default
            self._finished.append((r.finish_time, met, cls))
        self._n_seen = len(finished)
        cutoff = now - self.window
        while self._finished and self._finished[0][0] < cutoff:
            self._finished.popleft()

    # ---------------- signal reads ------------------------------------- #
    def _decay_to(self, now: float) -> None:
        if now > self._rate_t:
            self._rate *= math.exp(-(now - self._rate_t) / self.ewma_tau)
            self._rate_t = now

    def rate_ewma(self, now: float) -> float:
        self._decay_to(now)
        return self._rate

    def attainment_window(self) -> Optional[float]:
        """Min-over-classes attainment over the trailing window; None
        until ``min_samples`` completions populate it — one straggler in
        a near-empty window must not read as an SLO collapse (or a
        single lucky request as perfect health).  The guard is
        *per-class*: a class with fewer than ``min_samples`` window
        completions is excluded from the min (its one straggler says
        nothing), and only when NO class qualifies is the whole signal
        None.  With a single class this is exactly the old global
        guard."""
        if len(self._finished) < self.min_samples:
            return None
        hits: Dict[str, int] = {}
        tot: Dict[str, int] = {}
        for _, met, cls in self._finished:
            tot[cls] = tot.get(cls, 0) + 1
            hits[cls] = hits.get(cls, 0) + (1 if met else 0)
        vals = [hits[c] / tot[c] for c in tot
                if tot[c] >= self.min_samples]
        return min(vals) if vals else None

    @staticmethod
    def queue_depth(system) -> int:
        """System queue + admitted-but-unprefilled instance backlog."""
        return len(system.queue) + sum(
            len(i.pending) for i in system.instances)

    @staticmethod
    def kv_occupancy(system) -> float:
        cap = sum(i.kv_capacity_tokens for i in system.instances)
        if cap <= 0:
            return 0.0
        return sum(i.kv_tokens_used() for i in system.instances) / cap

    def snapshot(self, system, engine, now: float) -> Dict[str, float]:
        """One controller-tick reading of every signal."""
        self.consume_finished(engine.finished, now)
        att = self.attainment_window()
        return {
            "t": now,
            "rate_ewma": self.rate_ewma(now),
            "queue_depth": float(self.queue_depth(system)),
            "kv_occupancy": self.kv_occupancy(system),
            "attainment_window": att,
            "arrivals_total": float(self._arrivals),
            "n_instances": float(len(system.instances)),
        }
