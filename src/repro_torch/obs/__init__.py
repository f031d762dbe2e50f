"""repro_torch.obs — the unified flight recorder.

``events`` is the zero-overhead-when-off bus (safe to import from hot
paths); ``metrics`` derives per-instance time-series, TTFT attribution,
and the Fig. 2 interference score from a captured event list;
``export`` renders JSONL and Chrome-trace/Perfetto JSON.  Only the
events layer is re-exported here so importing ``repro_torch.obs`` stays as
cheap as the hot paths that depend on it.
"""
from repro_torch.obs.events import (NULL_TRACER, NullTracer, Tracer,
                              attach_decision_log, attach_tracer)

__all__ = ["NULL_TRACER", "NullTracer", "Tracer", "attach_decision_log",
           "attach_tracer"]
