"""repro_torch — the PyTorch / CUDA port of the EcoServe reproduction.

A second package beside the JAX one (``repro``), which stays the
reference.  It imports ``torch`` and never ``jax``, and nothing of
``repro``: the framework-free modules it needs (configs, core, obs,
faults.policies, simulator.{cost_model,engine}, serving.replay) are kept
as copies here.  Entry points run on ``cuda`` unless given
``device="cpu"``.
"""
