"""Real-execution serving stack of the port: the PyTorch engine
(``engine``), the replay harness (``replay``, copied from
``repro.serving``) and the PaDG server (``padg_server``)."""
