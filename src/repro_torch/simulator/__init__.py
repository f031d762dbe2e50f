from repro_torch.simulator.cost_model import (  # noqa: F401
    GPU_L20, GPU_A800, TPU_V5E_SIM, HardwareProfile, InstanceCostModel)
from repro_torch.simulator.workload import WORKLOADS, WorkloadGen  # noqa: F401
from repro_torch.simulator.engine import SimulationEngine          # noqa: F401
from repro_torch.simulator.scenarios import (  # noqa: F401
    SCENARIO_KINDS, Scenario, TraceReplay, make_scenario, write_trace)
from repro_torch.simulator.runner import ExperimentRunner          # noqa: F401
