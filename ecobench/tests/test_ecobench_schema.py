"""BENCHMARK.json against the benchmark's contract, the files it names,
and the result line's schema from a run at a CPU size."""
import json
import re

import pytest

from ecobench_testlib import REPO, cpu_run, tiny
from ecobench.harness import bench
from ecobench.harness.model import family_of

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_and_command():
    assert set(B) == KEYS
    assert B["paths"] == ["ecobench"]
    assert B["command"] == ["python3", "ecobench/run.py"]
    assert 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43200 s
    assert 2 * 90 * 24 + (2 + 14 * 24) * (B["run_seconds"] + 60) + 1200 \
        <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("ecobench/")
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert "\n" not in m["layer"]


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_cell_files_and_metrics(w):
    spec = bench.cell_spec(w)
    assert spec["cell"]["rate"] > 0
    assert spec["mix"]["regime"] in ("tail", "sat")
    e2e = bench.metric_names(B, w, False)
    per = bench.metric_names(B, w, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    moves = {m["name"]: m["moves"] for m in B["per_layer"]}
    for name in e2e + per:
        assert callable(bench.load_reader(name))
    for name in per:
        assert moves[name] in e2e          # it moves a metric the cell has
    roof = [n for n in per if "_roofline" in n]
    mfu = {moves[n] for n in per if "mfu" in n}
    assert {moves[n] for n in roof} <= mfu


@pytest.mark.parametrize("c", [c["name"] for c in B["configs"]])
def test_config_file_as_run(c):
    entry = next(x for x in B["configs"] if x["name"] == c)
    conf = json.loads((REPO / entry["file"]).read_text())
    assert conf["source"] == entry["source"]
    assert sorted(conf["reduced"]) == sorted(entry["reduced"])
    assert set(conf["published"]) == set(conf["reduced"])
    m = conf["model"]
    for k, hf in family_of(conf).SOURCE_KEYS.items():
        assert m[k] == conf[hf], k
    if "head_dim" in m and "head_dim" not in conf:
        # a source without head_dim splits the width among the heads
        assert m["head_dim"] * m["heads"] == m["d_model"]
    assert conf["engine"]["dtype"] == conf["torch_dtype"]


def test_port_widths_match_the_files():
    from ecobench.harness import serve
    from ecobench.harness.model import load_config, model_of
    for c in B["configs"]:
        conf = load_config(c["name"])
        cfg = serve.port_config(conf, model_of(conf))
        assert cfg.num_layers == conf["model"]["layers"]


def test_result_line_schema():
    out = cpu_run("qwen2-72b.longbench", 2**31 + 11, shrink=tiny(rate=4.0))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = set(bench.metric_names(B, "qwen2-72b.longbench", False))
    assert set(out["metrics"]) == want
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(out))
    assert out["correct"] is True and out["attempted"] >= 6
