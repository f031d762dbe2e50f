"""Real-trace ingestion: public serving traces -> replayable scenarios.

``convert`` parses the public Azure-LLM-inference and BurstGPT CSV
schemas into our tagged JSONL records, ``transforms`` adapts them
(time-rescale, rate-normalize, clip, downsample) and ``stats`` audits
the result.  Two small checked-in excerpts under ``fixtures/`` make the
pipeline runnable offline; ``fixture_replay`` turns one into a
``TraceReplay`` the simulator drives directly, and the scenario factory
exposes them as the ``"trace:azure"`` / ``"trace:burstgpt"`` kinds.

CLI: ``python -m repro_torch.traces <schema> <in.csv> <out.jsonl> [...]``.
"""
from __future__ import annotations

import pathlib
from typing import List, Optional

from repro_torch.traces.convert import (BURSTGPT_CLASS_BY_MODEL, CONVERTERS,
                                  TraceDict, convert_azure,
                                  convert_burstgpt, records_to_jsonl,
                                  write_jsonl)
from repro_torch.traces.stats import format_stats, trace_stats
from repro_torch.traces.transforms import (clip_horizon, downsample,
                                     normalize_rate, rescale_time, span)

FIXTURE_DIR = pathlib.Path(__file__).parent / "fixtures"

# name -> (csv filename, converter schema): the two checked-in excerpts
FIXTURES = {
    "azure": ("azure_llm_excerpt.csv", "azure"),
    "burstgpt": ("burstgpt_excerpt.csv", "burstgpt"),
}


def load_fixture(name: str, **convert_kw) -> List[TraceDict]:
    """Convert a checked-in excerpt to trace records."""
    if name not in FIXTURES:
        raise KeyError(f"unknown trace fixture {name!r}; expected one of "
                       f"{tuple(FIXTURES)}")
    fname, schema = FIXTURES[name]
    with open(FIXTURE_DIR / fname) as f:
        return CONVERTERS[schema](f, **convert_kw)


def fixture_replay(name: str, rate: Optional[float] = None,
                   loop: bool = False, **convert_kw):
    """A ``TraceReplay`` over a checked-in excerpt, optionally
    rate-normalized to ``rate`` req/s — the object ``make_scenario``
    returns for the ``"trace:<name>"`` scenario kinds.  ``loop=True``
    tiles the excerpt to cover experiment windows longer than its
    (normalized) span; the scenario factory always asks for this, so a
    grid cell's whole horizon sees trace-shaped traffic."""
    # imported here: scenarios.make_scenario lazily imports *us* for
    # "trace:" kinds, so a module-level import would be a cycle
    from repro_torch.simulator.scenarios import TraceReplay, _parse_trace
    records = load_fixture(name, **convert_kw)
    if rate is not None:
        records = normalize_rate(records, rate)
    return TraceReplay(f"trace:{name}",
                       _parse_trace(records_to_jsonl(records)), loop=loop)


__all__ = [
    "BURSTGPT_CLASS_BY_MODEL", "CONVERTERS", "FIXTURES", "FIXTURE_DIR",
    "TraceDict", "convert_azure", "convert_burstgpt", "records_to_jsonl",
    "write_jsonl", "trace_stats", "format_stats", "clip_horizon",
    "downsample", "normalize_rate", "rescale_time", "span",
    "load_fixture", "fixture_replay",
]
