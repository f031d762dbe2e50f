"""Multi-model fleet serving: cost-aware model routing + budget-
constrained pool rebalancing.

One cluster, several model pools — each an independent strategy stack
(``repro_torch.baselines``) over its own ``repro_torch.configs`` model and cost
model — sharing a global GPU budget:

    FleetSpec / PoolSpec   -- "name=model/strategy/n,...;budget=G"
    FleetSystem            -- the ServingSystem over the pools (disjoint
                              instance-id bands, fault-hook delegation,
                              FleetTransport)
    FleetRouter            -- request -> pool under "pinned" /
                              "cheapest-feasible" / "quality-tiered"
    FleetRebalanceHarness  -- per-pool control loops reconciled under
                              the budget: donor-funded capacity moves
                              through the mitosis/actuator path

``repro_torch.simulator.metrics.run_once`` installs the rebalancer for
``control="rebalance"`` fleet cells; the experiment runner exposes the
whole layer as the seed-neutral ``fleet=`` axis (the strategy slot then
names routers).  Depends on ``repro_torch.baselines``/``repro_torch.control``; the
simulator imports *us* lazily.
"""
from repro_torch.fleet.rebalance import FleetRebalanceHarness
from repro_torch.fleet.router import (ROUTERS, CheapestFeasibleRouter,
                                FleetRouter, PinnedRouter,
                                QualityTieredRouter, make_router)
from repro_torch.fleet.spec import (DEFAULT_GPU_PRICES, FleetSpec, PoolSpec,
                              dollars_per_token, parse_fleet)
from repro_torch.fleet.system import BAND, FleetSystem, FleetTransport

__all__ = [
    "BAND", "DEFAULT_GPU_PRICES", "CheapestFeasibleRouter",
    "FleetRebalanceHarness", "FleetRouter", "FleetSpec", "FleetSystem",
    "FleetTransport", "PinnedRouter", "PoolSpec", "QualityTieredRouter",
    "ROUTERS", "dollars_per_token", "make_router", "parse_fleet",
]
