"""Helpers of the benchmark's CPU tests: the path to the repository, a
tiny version of a cell (the port's widths cut with it), and the card
fixture.  Not a test module."""
from __future__ import annotations

import copy
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(layers=2, d_model=128, head_dim=32, d_ff=256, vocab=256)
TINY_LIMIT = 0.03


def cpu_run(cell, seed, seconds=2.0, trace=False, **kw):
    """``run_cell`` at a CPU size, every request served to its end, on two
    threads (the suite's workers share the host's cores)."""
    import torch
    from ecobench.harness import bench
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return bench.run_cell(cell, seed, seconds, trace, t_start=0.0,
                              device="cpu", drain=True,
                              log=lambda s: None, **kw)
    finally:
        torch.set_num_threads(n)


def tiny(dtype: str = "float32", rate: float = None, group: int = 4,
         max_batch: int = 4):
    """A ``shrink`` for ``run_cell``: the cell at a CPU size, G ``group``
    query heads a kv head, the rotary over the same share of the head."""
    def shrink(spec):
        spec = copy.deepcopy(spec)
        conf, mix = spec["conf"], spec["mix"]
        m = conf["model"]
        half = m["rope_dims"] * 2 == m["head_dim"]
        m.update(TINY, heads=2 * group, kv_heads=2,
                 rope_dims=TINY["head_dim"] // (2 if half else 1))
        conf["port_overrides"] = dict(
            d_model=m["d_model"], num_heads=m["heads"],
            num_kv_heads=m["kv_heads"], head_dim=m["head_dim"],
            d_ff=m["d_ff"], vocab_size=m["vocab"])
        conf["engine"].update(max_batch=max_batch, max_seq_len=160,
                              dtype=dtype, eos_token_id=1)
        mix["prompt"] = {"dist": "normal", "mean": 48, "sd_frac": 0.3,
                         "min": 4, "max": 96}
        mix["output"] = {"dist": "lognormal", "mean": 10, "median": 6,
                         "min": 2, "max": 24}
        # this size's limit: bf16 served tokens read 0.004-0.005, the
        # float8 control 0.07-0.2, the faults 0.8-1.5 (seeds 3, 77)
        conf["limits"] = {"widest_logit_gap": TINY_LIMIT}
        mix["warmup_requests"] = 2
        mix["check"] = {"tokens": 64, "requests": 6, "min_compared": 8}
        if rate is not None:
            spec["cell"]["rate"] = rate
        return spec
    return shrink
