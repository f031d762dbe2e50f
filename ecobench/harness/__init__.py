"""The benchmark's own code: traffic, weights, the plain reference, work
counts, the trace's reduction and the judgement of ``correct``.  Nothing
here imports ``repro_torch`` at module level; ``serve`` and ``bench``
reach the port only when a run starts."""
