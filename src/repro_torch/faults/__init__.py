"""Seeded, pure-sim-time fault model (ROADMAP item 5).

EcoServe's macro-instance orchestration claims graceful degradation
where FuDG systems — whose prefill->decode KV transfer depends on every
decode instance staying healthy — collapse.  This package makes instance
churn a first-class, reproducible experiment axis:

    FaultSchedule / make_fault_schedule
        declarative spec ("crash:t=14;spot:mtbf=20,notice=2") + cell
        seed -> a deterministic event list, fixed before the run
    FaultInjector
        pushes the schedule through the engine's event heap; resolves
        victims against the live pool at fire time
    FailurePolicy (drop / resubmit:K / migrate:K)
        the new slot on ``PolicySystemBase`` deciding the fate of
        in-flight requests when their instance goes away

``repro_torch.simulator.metrics.run_once(faults=...)`` installs the injector
for a cell; the experiment runner exposes it as the seed-neutral
``faults=`` grid axis (same contract as ``autoscale=``: identical
arrivals across fault levels, so degradation deltas isolate the fault).
Depends only on ``repro_torch.core`` — the simulator imports *us*.
"""
from repro_torch.faults.injector import FaultInjector, SlowExecutor
from repro_torch.faults.network import NETWORK_KINDS, NetworkModel
from repro_torch.faults.policies import (FAILURE_POLICIES, DropFailure,
                                   FailurePolicy, MigrateFailure,
                                   ResubmitFailure, make_failure_policy)
from repro_torch.faults.schedule import (FAULT_KINDS, FaultEvent, FaultSchedule,
                                   make_fault_schedule)

__all__ = [
    "FaultInjector", "SlowExecutor",
    "NETWORK_KINDS", "NetworkModel",
    "FAILURE_POLICIES", "DropFailure", "FailurePolicy", "MigrateFailure",
    "ResubmitFailure", "make_failure_policy",
    "FAULT_KINDS", "FaultEvent", "FaultSchedule", "make_fault_schedule",
]
