"""``FleetSystem``: N model pools behind one router, one engine, one
GPU budget.

Each pool is a full, independent strategy stack built by
``repro_torch.baselines.make_system`` — any registered spec or grammar
composition, over any ``repro_torch.configs`` model, with its own
``InstanceCostModel`` — minted into a disjoint instance-id band
(``iid_base = k * BAND``) so the engine's slot table and the mitosis
actor registry never collide across pools.  The fleet itself implements
the ``ServingSystem`` protocol: ``submit`` routes each request to a pool
(``repro_torch.fleet.router``) and records the assignment in ``pool_of_rid``
(the metrics layer scores per-pool attainment off it), ``on_slot_end``
dispatches to the owning pool by id band, and the fault hooks delegate
the same way so crash/preempt/network schedules compose unchanged.

A ``FleetTransport`` fronts the pools' transports: attaching a network
plane (fault injector) degrades every pool at once, and ``summary()``
sums the per-pool counters.  Capacity changes are the rebalancer's job
(``repro_torch.fleet.rebalance``); the fleet-level ``scale_up``/``scale_down``
exist for protocol conformance and act on the most/least pressured pool.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.request import Request
from repro_torch.core.slo import as_slo_class_set
from repro_torch.core.transport import Transport
from repro_torch.fleet.router import make_router
from repro_torch.obs.events import NULL_TRACER
from repro_torch.fleet.spec import (DEFAULT_GPU_PRICES, FleetSpec, dollars_per_token,
                              parse_fleet)
from repro_torch.simulator.cost_model import (GPU_A800, GPU_L20, TPU_V5E_SIM,
                                        InstanceCostModel)

# instance-id band stride per pool: far above any realistic per-pool id
# (FuDG decode ids sit at base+1000, scale-ups count from the band max)
BAND = 10_000

_HARDWARE = {"L20": GPU_L20, "A800": GPU_A800, "tpu-v5e": TPU_V5E_SIM}


class FleetTransport(Transport):
    """Fleet-level message plane fronting the per-pool transports: one
    ``attach_network`` degrades every pool, ``summary`` sums the fleet's
    own counters with the pools'."""

    def __init__(self, pool_transports: List[Transport]):
        super().__init__()
        self._pool_transports = list(pool_transports)

    def attach_network(self, network) -> None:
        super().attach_network(network)
        for t in self._pool_transports:
            t.attach_network(network)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.stats)
        for t in self._pool_transports:
            for k, v in t.stats.items():
                out[k] = out.get(k, 0) + v
        # pools mint iids in disjoint bands, but CTRL/POOL endpoints are
        # shared — merge per-link rows by key-sum
        merged: Dict[Any, Dict[str, int]] = {}
        for src_stats in ([self.link_stats]
                          + [t.link_stats for t in self._pool_transports]):
            for key, row in src_stats.items():
                acc = merged.setdefault(key, dict.fromkeys(row, 0))
                for k, v in row.items():
                    acc[k] = acc.get(k, 0) + v
        out["links"] = {f"{src}->{dst}": v
                        for (src, dst), v in sorted(merged.items())}
        return out


class FleetSystem:
    """Several model pools sharing one engine and one GPU budget."""

    base_name = "fleet"
    # flight-recorder hook (repro_torch.obs.attach_tracer wires this plus every
    # member pool's own tracer slot)
    tracer = NULL_TRACER

    def __init__(self, spec, slo, *, hw: str = "L20", tp: int = 4,
                 pp: int = 1, router="pinned",
                 prices: Optional[Dict[str, float]] = None):
        # imported here: repro_torch.baselines imports the simulator package,
        # which must stay importable without the fleet layer
        from repro_torch.baselines import make_system
        if isinstance(spec, str):
            spec = parse_fleet(spec, devices_per_instance=tp * pp)
        if not isinstance(spec, FleetSpec):
            raise TypeError(f"cannot build a fleet from {type(spec)!r}")
        self.spec = spec
        self.hw = hw
        self.budget = spec.budget
        self.router = make_router(router)
        self.slo_set = as_slo_class_set(slo)
        self.prices = dict(prices or DEFAULT_GPU_PRICES)
        self.pools: List[Any] = []
        self.pool_names: List[str] = []
        self.pool_by_model: Dict[str, int] = {}
        self.pool_quality: List[float] = []   # pool model param count
        self.model_quality: Dict[str, float] = {}
        self.cost_per_token: List[float] = []
        self.routed_counts: List[int] = []
        for k, ps in enumerate(spec.pools):
            cfg = get_config(ps.model)
            cost = InstanceCostModel(cfg=cfg, hw=_HARDWARE[hw],
                                     tp=tp, pp=pp)
            pool = make_system(ps.strategy, cost, ps.n_instances,
                               slo, iid_base=k * BAND)
            self.pools.append(pool)
            self.pool_names.append(ps.name)
            self.pool_by_model.setdefault(ps.model, k)
            q = float(cfg.param_count())
            self.pool_quality.append(q)
            self.model_quality[ps.model] = q
            self.cost_per_token.append(
                dollars_per_token(cost, hw, self.prices))
            self.routed_counts.append(0)
        committed = sum(p.n_instances * self.pools[k].cost.devices
                       for k, p in enumerate(spec.pools))
        if committed > self.budget:
            raise ValueError(f"fleet commits {committed} GPUs over its "
                             f"budget of {self.budget}")
        self.pool_of_rid: Dict[int, int] = {}
        # rebalancer arrival tap: called as on_route(k, req, now) right
        # after the router assigns a pool; None keeps submit tap-free
        self.on_route: Optional[Callable[[int, Request, float], None]] = None
        self.transport = FleetTransport([p.transport for p in self.pools])
        self.spec_name: Optional[str] = None
        self.provenance = ""

    # ---------------- pool lookup -------------------------------------- #
    def pool_index_of_iid(self, iid: int) -> int:
        return iid // BAND

    def owner_of(self, inst) -> Any:
        """The pool system owning an instance (fault injector hook: the
        per-pool ``fault_stats`` must take the accounting)."""
        return self.pools[self.pool_index_of_iid(inst.iid)]

    @property
    def instances(self) -> List:
        return [i for p in self.pools for i in p.instances]

    @property
    def fault_stats(self) -> Dict[str, int]:
        """Fleet-wide fault accounting: the sum over pools.  Read-only
        by construction — mutators must go through ``owner_of``."""
        out: Dict[str, int] = {}
        for p in self.pools:
            for k, v in p.fault_stats.items():
                out[k] = out.get(k, 0) + v
        return out

    # ---------------- engine hooks ------------------------------------- #
    def submit(self, req: Request, now: float, engine) -> None:
        if req.model is not None and req.model not in self.model_quality:
            # capability rank of a tag no pool serves: its config's size
            # when registered, else 0 (no claim -> feasible anywhere)
            try:
                q = float(get_config(req.model).param_count())
            except KeyError:
                q = 0.0
            self.model_quality[req.model] = q
        k = self.router.route(req, self, now)
        self.pool_of_rid[req.rid] = k
        self.routed_counts[k] += 1
        trc = self.tracer
        if trc.enabled:
            trc.control(now, "fleet_route", (req.rid, k))
        if self.on_route is not None:
            self.on_route(k, req, now)
        self.pools[k].submit(req, now, engine)

    def on_slot_end(self, inst, kind: str, reqs: List[Request],
                    now: float, engine) -> None:
        self.pools[self.pool_index_of_iid(inst.iid)].on_slot_end(
            inst, kind, reqs, now, engine)

    # ---------------- scaling (protocol conformance) ------------------- #
    def _queue_per_inst(self, k: int) -> float:
        pool = self.pools[k]
        depth = len(pool.queue) + sum(len(i.pending) for i in pool.instances)
        return depth / max(1, len(pool.instances))

    def scale_up(self, engine=None):
        """Grow the most backlogged pool (deterministic tie: pool
        order).  The rebalancer drives per-pool actuators directly; this
        fleet-level hook serves the bare mitosis protocol."""
        k = max(range(len(self.pools)),
                key=lambda j: (self._queue_per_inst(j), -j))
        return self.pools[k].scale_up(engine)

    def scale_down(self, now=None, engine=None):
        """Shrink the calmest pool that can spare an instance."""
        order = sorted(range(len(self.pools)),
                       key=lambda j: (self._queue_per_inst(j), j))
        for k in order:
            if len(self.pools[k].instances) > 1:
                gone = self.pools[k].scale_down(now, engine)
                if gone is not None:
                    return gone
        return None

    # ---------------- fault hooks (delegated by id band) --------------- #
    def detach_instance(self, inst) -> None:
        self.owner_of(inst).detach_instance(inst)

    def fault_crash(self, inst, now: float, engine) -> List[Request]:
        return self.owner_of(inst).fault_crash(inst, now, engine)

    def fault_preempt(self, inst, notice: float, now: float,
                      engine) -> None:
        self.owner_of(inst).fault_preempt(inst, notice, now, engine)

    def fault_lost_requests(self, reqs: List[Request], now: float,
                            engine) -> None:
        # no owning instance: attribute by routing record (all of one
        # transfer's requests share a pool), pool 0 as a last resort
        k = self.pool_of_rid.get(reqs[0].rid, 0) if reqs else 0
        self.pools[k].fault_lost_requests(reqs, now, engine)

    # ---------------- self-description --------------------------------- #
    def describe(self) -> Dict[str, Any]:
        return {
            "strategy": self.spec_name or f"fleet:{self.router.name}",
            "base": "fleet",
            "router": self.router.describe(),
            "budget": self.budget,
            "pools": [{
                "name": self.pool_names[k],
                "model": ps.model,
                "strategy": ps.strategy,
                "n_instances": len(self.pools[k].instances),
                "devices_per_instance": self.pools[k].cost.devices,
                "dollars_per_token": round(self.cost_per_token[k], 10),
            } for k, ps in enumerate(self.spec.pools)],
            "provenance": self.provenance,
        }

    def fleet_summary(self) -> Dict[str, Any]:
        """JSON-safe routing/budget digest for result rows."""
        return {
            "router": self.router.name,
            "budget": self.budget,
            "committed": sum(len(p.instances) * p.cost.devices
                             for p in self.pools),
            "routed": dict(zip(self.pool_names, self.routed_counts)),
            "n_instances": {self.pool_names[k]: len(p.instances)
                            for k, p in enumerate(self.pools)},
        }
