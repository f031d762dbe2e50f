"""DistServe-style intra-node FuDG baseline (paper §4.1 baseline 3).

Each node hosts prefill instances and decode instances; the KV cache of
every request crosses the node's internal interconnect (PCIe on the
paper's L20 cluster — no NVLink) from prefill to decode instance.  TP
traffic and KV migration contend for that link; we model the contention
with a per-node FIFO link.  As a policy composition: immediate admission
over prefill-partitioned routing; the KV migration itself is the
family-specific ``_on_prefill_handoff`` hook.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.instance import Instance
from repro_torch.core.request import Request, RequestState
from repro_torch.core.system import PolicySystemBase
from repro_torch.simulator.cost_model import InstanceCostModel
from repro_torch.simulator.engine import Link, SimulationEngine


class _PrefillInstance(Instance):
    decode_here = False


class DistServeSystem(PolicySystemBase):
    base_name = "distserve"
    default_queue = "fifo"
    default_admission = "immediate"
    default_routing = "prefill-least-pending"

    def __init__(self, cost: InstanceCostModel, n_instances: int, slo=None,
                 prefill_ratio: float = 0.5, n_nodes: int = None,
                 queue_discipline=None, admission=None, routing=None,
                 failure=None, iid_base: int = 0):
        """``n_instances`` total; a ``prefill_ratio`` fraction become
        prefill instances, the rest decode instances, colocated per node."""
        self.prefill_ratio = prefill_ratio
        self._n_nodes = n_nodes
        super().__init__(cost, n_instances, slo,
                         queue_discipline=queue_discipline,
                         admission=admission, routing=routing,
                         failure=failure, iid_base=iid_base)

    def _build(self, n_instances: int) -> None:
        cost = self.cost
        n_prefill = max(1, round(n_instances * self.prefill_ratio))
        n_decode = max(1, n_instances - n_prefill)
        self.prefill_insts: List[Instance] = [
            _PrefillInstance(self.iid_base + i, cost,
                             cost.kv_capacity_tokens())
            for i in range(n_prefill)
        ]
        # decode ids sit 1000 above the band base — far enough from any
        # realistic prefill count, and still inside the pool's band when
        # a fleet hands out bases in strides of 10000
        self.decode_insts: List[Instance] = [
            Instance(self.iid_base + 1000 + i, cost,
                     cost.kv_capacity_tokens())
            for i in range(n_decode)
        ]
        self.instances = self.prefill_insts + self.decode_insts
        # instances per node (both kinds share the node's PCIe link)
        per_node = max(1, cost.hw.devices_per_node // cost.devices)
        n_nodes = self._n_nodes or -(-n_instances // per_node)
        self.links: Dict[int, Link] = {
            n: Link(f"pcie-node{n}", cost.hw.intra_node_bw)
            for n in range(n_nodes)
        }
        self._per_node = per_node
        self._node_of: Dict[int, int] = {}
        for idx, inst in enumerate(self.instances):
            self._node_of[inst.iid] = (idx // per_node) % n_nodes

    def scale_up(self, engine=None) -> Instance:
        inst = super().scale_up(engine)   # joins decode_insts via routing
        idx = len(self.instances) - 1
        self._node_of[inst.iid] = (idx // self._per_node) % len(self.links)
        return inst

    # ------------------------------------------------------------------ #
    def _on_prefill_handoff(self, inst, reqs: List[Request], now,
                            engine: SimulationEngine) -> None:
        link = self.links[self._node_of[inst.iid]]
        tr = self.transport
        for r in reqs:
            targets = [i for i in self.decode_insts if i.alive]
            if not targets:
                # every decode instance is dead: the FuDG cliff — the KV
                # cache has nowhere to land, so the request is lost
                self.fault_lost_requests([r], now, engine)
                continue
            reachable = tr.filter_reachable(targets, now)
            if reachable:
                # prefer reachable decoders; with every one unreachable
                # the transfer goes out anyway and the retry/timeout
                # machinery decides its fate
                targets = reachable
            target = min(targets, key=lambda i: i.kv_tokens_used())
            nbytes = self.cost.kv_transfer_bytes(r.prompt_len)

            def deliver(r=r, target=target):
                if not target.alive:
                    # decode target died while the KV was in flight
                    self.fault_lost_requests([r], engine.now, engine)
                    return
                r.state = RequestState.DECODING
                if r.tokens_generated >= r.output_len:
                    r.state = RequestState.FINISHED
                    r.finish_time = engine.now
                    engine.finished.append(r)
                    return
                target.add_decoding(r)
                engine.activate(target)

            def on_lost(r=r):
                # retry budget exhausted on the degraded interconnect:
                # the KV never landed, the request flows through the
                # failure policy like any other in-transit loss
                self.fault_lost_requests([r], engine.now, engine)

            tr.transfer(engine, inst.iid, target.iid, nbytes, now,
                        deliver, on_lost, link=link)
