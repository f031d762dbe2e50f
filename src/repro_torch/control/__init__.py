"""Closed-loop autoscaling control plane (paper §3.5 made *reactive*).

The mitosis machinery (``repro_torch.core.mitosis``) defines how the pool
grows and shrinks; this package decides *when*, from observed load:

    SignalCollector  -- engine/system events -> windowed load signals
    ScalingController -- signals -> scale decisions (target band +
                         hysteresis/cooldown; plus a trace-oblivious
                         threshold baseline for ablation)
    Actuator          -- decisions -> ``scale_up``/``scale_down`` with a
                         modeled provisioning delay, recorded on a
                         ``ScalingTimeline``
    ControlLoopHarness -- wires all three onto a live (system, engine)

``repro_torch.simulator.metrics.run_once(control=...)`` installs the harness
for a cell; the experiment runner exposes it as the ``autoscale=`` grid
axis.  Depends only on ``repro_torch.core`` — the simulator imports *us*.
"""
from repro_torch.control.actuator import (Actuator, ControlLoopHarness,
                                    ScalingEvent, ScalingTimeline)
from repro_torch.control.controller import (CONTROLLERS, ControllerConfig,
                                      ScalingController,
                                      TargetBandController,
                                      ThresholdController, make_controller)
from repro_torch.control.signals import SignalCollector

__all__ = [
    "Actuator", "ControlLoopHarness", "ScalingEvent", "ScalingTimeline",
    "CONTROLLERS", "ControllerConfig", "ScalingController",
    "TargetBandController", "ThresholdController", "make_controller",
    "SignalCollector",
]
