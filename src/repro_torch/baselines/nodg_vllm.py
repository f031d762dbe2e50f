"""vLLM-style NoDG baseline: independent replicas, separate batching,
prefill-priority scheduling (paper §4.1 baseline 1).

Each instance handles the full request lifecycle; as a policy
composition this is immediate admission over least-KV routing — requests
enter the least-loaded replica on arrival, so prefills constantly
interrupt decodes on every replica (the interference PaDG removes) and
the system-level queue stays empty.  Composing a different bundle turns
the same machinery SLO-aware: ``"vllm+priority"`` swaps in backpressure
admission + an EDF queue over per-class TTFT deadlines.
"""
from __future__ import annotations

from repro_torch.core.system import PolicySystemBase
from repro_torch.simulator.cost_model import InstanceCostModel


class VLLMSystem(PolicySystemBase):
    base_name = "vllm"
    default_queue = "fifo"
    default_admission = "immediate"
    default_routing = "least-kv"

    def __init__(self, cost: InstanceCostModel, n_instances: int, slo=None,
                 queue_discipline=None, admission=None, routing=None,
                 failure=None, iid_base: int = 0):
        super().__init__(cost, n_instances, slo,
                         queue_discipline=queue_discipline,
                         admission=admission, routing=routing,
                         failure=failure, iid_base=iid_base)
