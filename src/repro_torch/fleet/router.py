"""Fleet routers: request -> pool assignment policies.

Every arriving request carries an optional ``model`` tag (trace
converters preserve it from the raw logs; ``MixedScenario`` tenants pin
it); the router turns that tag plus live pool state into a pool index.
Three policies, all pure functions of (request, fleet state) with
deterministic tie-breaks, so fleet cells replay bit-exactly:

* ``pinned`` — the model tag maps to the pool serving that model;
  untagged or unknown-model requests land on the first pool (the
  fleet's declared default).  The static-assignment baseline.
* ``cheapest-feasible`` — among pools whose model is at least as large
  as the requested one (parameter count, the capability proxy), pick
  the lowest decode $/token; unknown/untagged requests may land
  anywhere.  Ignores queues entirely: the cost-floor baseline.
* ``quality-tiered`` — prefer the pinned pool, but when its estimated
  queue wait already breaches the request's TTFT budget, spill to the
  cheapest other pool that is not itself breaching.  Trades model
  quality for latency only under pressure.

Routers see the fleet read-only; capacity changes are the rebalancer's
job (``repro_torch.fleet.rebalance``).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.request import Request

ROUTERS: Dict[str, type] = {}


def register_router(cls):
    ROUTERS[cls.name] = cls
    return cls


class FleetRouter:
    """Base: ``route`` returns the pool index for one request."""

    name = "router"

    def route(self, req: Request, fleet, now: float) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name

    # ---------------- shared helpers ----------------------------------- #
    @staticmethod
    def _pinned_pool(req: Request, fleet) -> int:
        """Pool serving the request's model tag; pool 0 for untagged or
        unknown tags (the declared default pool)."""
        if req.model is not None:
            k = fleet.pool_by_model.get(req.model)
            if k is not None:
                return k
        return 0

    @staticmethod
    def _feasible(req: Request, fleet):
        """Pool indices capable of serving the request: pools whose
        model is at least as large as the requested one.  Untagged or
        unregistered model names are feasible everywhere (no capability
        claim to honor)."""
        want = fleet.model_quality.get(req.model, 0.0) \
            if req.model is not None else 0.0
        ks = [k for k in range(len(fleet.pools))
              if fleet.pool_quality[k] >= want]
        return ks or list(range(len(fleet.pools)))

    @staticmethod
    def _queue_wait_estimate(fleet, k: int, req: Request) -> float:
        """Crude head-of-line wait bound for pool ``k``: backlog depth
        per live instance times one prefill of the request's own length
        (queued work is tenant-correlated, so the request's own shape is
        the cheapest proxy for what sits ahead of it).  Deliberately
        model-based and state-light — the router must stay O(pools) per
        request and fully deterministic."""
        pool = fleet.pools[k]
        depth = len(pool.queue) + sum(len(i.pending) for i in pool.instances)
        n = max(1, sum(1 for i in pool.instances if i.alive))
        return (depth / n) * pool.cost.predict_prefill(req.prompt_len)


@register_router
class PinnedRouter(FleetRouter):
    name = "pinned"

    def route(self, req: Request, fleet, now: float) -> int:
        return self._pinned_pool(req, fleet)


@register_router
class CheapestFeasibleRouter(FleetRouter):
    name = "cheapest-feasible"

    def route(self, req: Request, fleet, now: float) -> int:
        return min(self._feasible(req, fleet),
                   key=lambda k: (fleet.cost_per_token[k], k))


@register_router
class QualityTieredRouter(FleetRouter):
    name = "quality-tiered"

    def route(self, req: Request, fleet, now: float) -> int:
        preferred = self._pinned_pool(req, fleet)
        budget = fleet.slo_set.for_request(req).ttft
        if self._queue_wait_estimate(fleet, preferred, req) <= budget:
            return preferred
        # preferred pool is drowning: spill to the cheapest other pool
        # that still has TTFT headroom (deterministic: price, then index)
        spill = [k for k in range(len(fleet.pools)) if k != preferred
                 and self._queue_wait_estimate(fleet, k, req) <= budget]
        if not spill:
            return preferred        # everyone is breaching: don't shuffle
        return min(spill, key=lambda k: (fleet.cost_per_token[k], k))


def make_router(spec) -> FleetRouter:
    """``"pinned"`` / ``"cheapest-feasible"`` / ``"quality-tiered"`` or a
    ``FleetRouter`` instance passed through."""
    if isinstance(spec, FleetRouter):
        return spec
    if not isinstance(spec, str) or spec not in ROUTERS:
        raise KeyError(f"unknown fleet router {spec!r}; expected one of "
                       f"{tuple(ROUTERS)}")
    return ROUTERS[spec]()
