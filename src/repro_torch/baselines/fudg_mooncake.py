"""MoonCake-style inter-node FuDG baseline (paper §4.1 baseline 4).

Prefill and decode instances live on different nodes; KV caches travel
through a centralized pool: prefill node NIC -> pool -> decode node NIC,
i.e. ALWAYS two NIC traversals even when instances share a node (the
paper notes this explicitly).  Ethernet NICs are per-node FIFO links.
Same policy bundle as DistServe (immediate admission, prefill-partitioned
routing); only the ``_on_prefill_handoff`` transfer path differs.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.instance import Instance
from repro_torch.core.request import Request, RequestState
from repro_torch.core.system import PolicySystemBase
from repro_torch.core.transport import POOL
from repro_torch.simulator.cost_model import InstanceCostModel
from repro_torch.simulator.engine import Link, SimulationEngine


class _PrefillInstance(Instance):
    decode_here = False


class MoonCakeSystem(PolicySystemBase):
    base_name = "mooncake"
    default_queue = "fifo"
    default_admission = "immediate"
    default_routing = "prefill-least-pending"

    def __init__(self, cost: InstanceCostModel, n_instances: int, slo=None,
                 prefill_ratio: float = 0.5,
                 queue_discipline=None, admission=None, routing=None,
                 failure=None, iid_base: int = 0):
        self.prefill_ratio = prefill_ratio
        super().__init__(cost, n_instances, slo,
                         queue_discipline=queue_discipline,
                         admission=admission, routing=routing,
                         failure=failure, iid_base=iid_base)

    def _build(self, n_instances: int) -> None:
        cost = self.cost
        n_prefill = max(1, round(n_instances * self.prefill_ratio))
        n_decode = max(1, n_instances - n_prefill)
        self.prefill_insts = [
            _PrefillInstance(self.iid_base + i, cost,
                             cost.kv_capacity_tokens())
            for i in range(n_prefill)
        ]
        # decode ids 1000 above the band base (see DistServe: disjoint
        # from prefill ids, inside the pool's fleet band)
        self.decode_insts = [
            Instance(self.iid_base + 1000 + i, cost,
                     cost.kv_capacity_tokens())
            for i in range(n_decode)
        ]
        self.instances = self.prefill_insts + self.decode_insts
        # one instance per node (the paper's deployment to ease bandwidth
        # contention); each node's NIC is a FIFO link
        self.nic: Dict[int, Link] = {
            inst.iid: Link(f"nic-{inst.iid}", cost.hw.inter_node_bw)
            for inst in self.instances
        }

    def scale_up(self, engine=None) -> Instance:
        inst = super().scale_up(engine)   # joins decode_insts via routing
        self.nic[inst.iid] = Link(f"nic-{inst.iid}",
                                  self.cost.hw.inter_node_bw)
        return inst

    # ------------------------------------------------------------------ #
    def _on_prefill_handoff(self, inst, reqs: List[Request], now,
                            engine: SimulationEngine) -> None:
        src_nic = self.nic[inst.iid]
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
                # the pool upload still happens and the download's
                # retry/timeout machinery decides the request's fate
                targets = reachable
            target = min(targets, key=lambda i: i.kv_tokens_used())
            nbytes = self.cost.kv_transfer_bytes(r.prompt_len)

            def on_lost(r=r):
                # either NIC traversal exhausted its retry budget: the
                # KV never reached the decoder, the request flows
                # through the failure policy like any in-transit loss
                self.fault_lost_requests([r], engine.now, engine)

            def stage2(r=r, target=target, nbytes=nbytes, on_lost=on_lost):
                if not target.alive:
                    # decode target died while the KV sat in the pool
                    self.fault_lost_requests([r], engine.now, engine)
                    return
                dst_nic = self.nic[target.iid]

                def deliver(r=r, target=target):
                    if not target.alive:
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

                tr.transfer(engine, POOL, target.iid, nbytes, engine.now,
                            deliver, on_lost, link=dst_nic)  # pool -> decode

            tr.transfer(engine, inst.iid, POOL, nbytes, now,
                        stage2, on_lost, link=src_nic)       # prefill -> pool
