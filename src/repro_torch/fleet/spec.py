"""Fleet declaration: which model pools share the cluster, under what
GPU budget, at what price.

A fleet is N independent strategy stacks ("pools"), each serving one
model with its own cost model, mitosis machinery, and policy bundle,
sharing a global GPU budget.  ``parse_fleet`` turns the grid-spec string

    "chat=llama-30b/ecoserve/4,code=qwen1.5-32b/ecoserve/2;budget=24"

into a ``FleetSpec``: comma-separated pools (``name=model/strategy/n``
— slash-separated inside a pool because strategy names carry ``+``),
then ``;``-separated fleet options (only ``budget=<gpus>`` today).  The
budget defaults to the committed device count, i.e. a fully packed
cluster where growth is only possible by taking capacity from a donor
pool — the regime the rebalancer exists for.

``dollars_per_token`` prices a pool's *decode* output from its cost
model at a reference operating point (batch 8, 1k context): the
cheapest-feasible router ranks pools by it, so "cheap" means measured
throughput per list-price dollar, not parameter count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# list-price-style $/GPU-hour figures (on-demand cloud ballpark; only
# the RATIOS matter to the router, and they ride in result rows so the
# assumption is auditable)
DEFAULT_GPU_PRICES: Dict[str, float] = {
    "L20": 1.28,
    "A800": 2.80,
    "tpu-v5e": 1.20,
}

# decode reference operating point for $/token pricing
_REF_BATCH = 8
_REF_CTX = 1024


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One model pool: a named strategy stack inside the fleet."""

    name: str
    model: str            # repro_torch.configs model key ("llama-30b", ...)
    strategy: str         # any resolvable strategy / grammar composition
    n_instances: int      # initial instance count


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Pools + the shared GPU budget (in devices, i.e. tp*pp units)."""

    pools: Tuple[PoolSpec, ...]
    budget: int           # total GPUs the fleet may commit at once

    def committed_devices(self, devices_per_instance: int) -> int:
        """Initial committed GPUs with a uniform parallelism degree."""
        return sum(p.n_instances for p in self.pools) * devices_per_instance


def parse_fleet(spec: str, devices_per_instance: int = 1) -> FleetSpec:
    """Parse a fleet spec string; ``devices_per_instance`` (= tp*pp of
    the cells the fleet will run under) sizes the default budget."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty fleet spec")
    pool_part, _, opt_part = spec.partition(";")
    pools = []
    seen = set()
    for entry in pool_part.split(","):
        entry = entry.strip()
        name, eq, rest = entry.partition("=")
        fields = rest.split("/")
        if not eq or len(fields) != 3 or not name:
            raise ValueError(
                f"bad pool entry {entry!r}; expected name=model/strategy/n")
        model, strategy, n_str = (f.strip() for f in fields)
        n = int(n_str)
        if n < 1:
            raise ValueError(f"pool {name!r} needs >= 1 instance, got {n}")
        if name in seen:
            raise ValueError(f"duplicate pool name {name!r}")
        seen.add(name)
        pools.append(PoolSpec(name=name, model=model, strategy=strategy,
                              n_instances=n))
    budget = None
    if opt_part.strip():
        for opt in opt_part.split(";"):
            k, _, v = opt.strip().partition("=")
            if k != "budget" or not v:
                raise ValueError(f"unknown fleet option {opt.strip()!r}; "
                                 "expected budget=<gpus>")
            budget = int(v)
    fleet = FleetSpec(pools=tuple(pools), budget=budget or 0)
    committed = fleet.committed_devices(devices_per_instance)
    if budget is None:
        fleet = dataclasses.replace(fleet, budget=committed)
    elif budget < committed:
        raise ValueError(
            f"fleet budget {budget} GPUs < {committed} committed by the "
            f"pool spec at {devices_per_instance} devices/instance")
    return fleet


def dollars_per_token(cost, hw_name: str,
                      prices: Dict[str, float] = None) -> float:
    """Decode $/token of one instance under ``cost``
    (``InstanceCostModel`` or a calibrated executor with the same
    surface) at the reference operating point."""
    price_hr = (prices or DEFAULT_GPU_PRICES).get(hw_name)
    if price_hr is None:
        raise KeyError(f"no GPU price for hardware {hw_name!r}; known: "
                       f"{tuple(DEFAULT_GPU_PRICES)}")
    dollars_per_s = cost.devices * price_hr / 3600.0
    iter_time = cost.decode_time(_REF_BATCH, ctx_sum=_REF_BATCH * _REF_CTX)
    tokens_per_s = _REF_BATCH / iter_time
    return dollars_per_s / tokens_per_s
