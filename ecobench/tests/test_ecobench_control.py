"""The control: the reference in float8 in the program's place has to come
out as not correct, where the bfloat16 program is.  At a CPU size here
(against that size's limit); at each configuration's own size on the card
(``card`` fixture; run there with
``python3 -m pytest -q ecobench/tests/test_ecobench_control.py``)."""
import json

import pytest

from ecobench_testlib import REPO, TINY_LIMIT, cpu_run, tiny
from ecobench.harness import bench


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs only "
                    "on the card")


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_control_fails_where_the_program_passes_cpu(seed):
    out = cpu_run("qwen2-72b.longbench", seed,
                  shrink=tiny(dtype="bfloat16", rate=6.0, group=16),
                  control=True)
    assert out["checks"]["widest_logit_gap"]["value"] <= TINY_LIMIT
    assert out["control_widest_logit_gap"] > TINY_LIMIT


CARD_CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]
    if not w["name"].endswith(".sat")]


@pytest.mark.usefixtures("card")
@pytest.mark.parametrize("cell", CARD_CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_control_fails_at_the_cells_size(cell, seed):
    import time
    out = bench.run_cell(cell, seed, 12.0, False,
                         t_start=time.perf_counter(), control=True)
    limit = out["checks"]["widest_logit_gap"]["limit"]
    assert out["checks"]["widest_logit_gap"]["value"] <= limit
    assert out["control_widest_logit_gap"] > limit
