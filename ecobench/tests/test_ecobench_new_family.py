"""A model family enters the benchmark by new files alone.

Into a directory of its own the test writes a windowed dense family
(llama3-8b-sw's kind: every layer attends over its last ``window``
positions) with its own reference and work counts, a configuration of it
at a CPU size, a traffic mix, a cell, a kernel file that counts the
windowed prefill calls, and a metric that reads a counter of the
program's (``Run.meta``).  With the search roots pointed there first and
``BENCHMARK.json`` copied with the new entries, one traced run at a CPU
size serves the cell through the port, judges it against the family's
reference, reads the metric and counts the kernel's calls; no file of
``ecobench/harness/`` changes."""
import hashlib
import json

from ecobench_testlib import REPO, cpu_run
from ecobench.harness import files

FAMILY = '''
"""Dense, every layer's attention over its last ``window`` positions."""
import dataclasses

import torch
import torch.nn.functional as F

from ecobench.harness import files, reference as R

DENSE = files.module("families", "dense")
SOURCE_KEYS = dict(DENSE.SOURCE_KEYS, window="sliding_window")
draw, port_params = DENSE.draw, DENSE.port_params


@dataclasses.dataclass(frozen=True)
class Model(DENSE.Model):
    window: int


def port_fields(m):
    return dict(DENSE.port_fields(m), block_pattern=("local",),
                sliding_window=m.window)


def attention(q, k, v, m, control):
    T, D, G = q.shape[0], m.head_dim, m.group
    qh = q.view(T, m.kv_heads, G, D).permute(1, 2, 0, 3)   # (Hkv, G, T, D)
    kh, vh = k.permute(1, 2, 0), v.permute(1, 0, 2)        # (Hkv, D|T, T|D)
    if control:
        qh, kh, vh = R.fp8(qh, -1), R.fp8(kh, 1), R.fp8(vh, 1)
    s = (qh @ kh[:, None]) * D ** -0.5
    i = torch.arange(T, device=q.device)
    far = (i[None, :] > i[:, None]) | (i[None, :] <= i[:, None] - m.window)
    p = torch.softmax(s.masked_fill(far, float("-inf")), dim=-1)
    if control:
        p = R.fp8(p, -1)
    return (p @ vh[:, None]).permute(2, 0, 1, 3).reshape(T, m.heads * D)


def layer(x, lw, m, control):
    T, hd = x.shape[0], m.head_dim
    h = R.rms_norm(x, lw["attn_norm"], m.norm_eps)
    q, k, v = (R._mm(h, lw[n], control) for n in ("wq", "wk", "wv"))
    q = R.rope(q.view(T, m.heads, hd), m)
    k = R.rope(k.view(T, m.kv_heads, hd), m)
    v = v.view(T, m.kv_heads, hd)
    x = x + R._mm(attention(q, k, v, m, control), lw["wo"], control)
    h = R.rms_norm(x, lw["mlp_norm"], m.norm_eps)
    g = F.silu(R._mm(h, lw["w_gate"], control)) * R._mm(h, lw["w_up"],
                                                        control)
    return x + R._mm(g, lw["w_down"], control)


def logits_at(w, m, seqs, rows, control=False):
    def weight(t):
        t = t.float()
        return R.fp8(t, 0) if control and t.ndim == 2 else t
    xs = [w["embed"][torch.as_tensor(list(s))].float() for s in seqs]
    for lw in w["layers"]:
        lw32 = {k: weight(t) for k, t in lw.items()}
        xs = [layer(x, lw32, m, control) for x in xs]
    head = weight(w["lm_head"])
    return [R._mm(R.rms_norm(x[torch.as_tensor(list(r))], w["final_norm"],
                             m.norm_eps), head, control)
            for x, r in zip(xs, rows)]


def prefill_flops(m, T):
    pairs = sum(min(i + 1, m.window) for i in range(T))
    return (2.0 * m.layer_matmul_params() * T * m.layers
            + 4.0 * m.head_dim * m.heads * pairs * m.layers
            + 2.0 * m.d_model * m.vocab)


def decode_flops(m, batch, ctx_sum):       # at most the window a sequence
    return DENSE.decode_flops(m, batch, min(ctx_sum, batch * m.window))
'''

KERNEL = '''
"""flash_prefill_op's windowed calls (the dense file counts the others)."""
ATTR = "flash_prefill_op"


def work(args, kwargs, step):
    W = kwargs.get("window", 0)
    if not W:
        return None
    q, k = args[0], args[1]
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    pairs = sum(min(i + 1, W) for i in range(T))
    return (4.0 * D * Hq * B * pairs,
            q.element_size() * B * (2 * T * Hq * D + 2 * S * Hkv * D))
'''

METRIC = '''
"""Instances whose decode-graph counters the program reported."""


def read(run):
    graphs = (run.meta or {}).get("decode_graph")
    return None if graphs is None else len(graphs)
'''

WIDTHS = dict(layers=2, d_model=128, heads=8, kv_heads=2, head_dim=32,
              d_ff=256, vocab=256, qkv_bias=False, rope_dims=32,
              rope_theta=500000.0, norm_eps=1e-6, window=24)
CONFIG = {
    "name": "toy-sw", "family": "windowed", "port_config": "llama3-8b-sw",
    "model": WIDTHS,
    "port_overrides": dict(d_model=128, num_heads=8, num_kv_heads=2,
                           head_dim=32, d_ff=256, vocab_size=256,
                           sliding_window=24),
    "engine": {"n_instances": 2, "max_batch": 4, "max_seq_len": 160,
               "dtype": "float32", "eos_token_id": 1},
    "limits": {"widest_logit_gap": 0.03},
}
MIX = {
    "name": "toy", "regime": "tail", "slo": {"ttft_s": 15.0, "tpot_s": 0.1},
    "prompt": {"dist": "normal", "mean": 48, "sd_frac": 0.3, "min": 4,
               "max": 96},
    "output": {"dist": "lognormal", "mean": 10, "median": 6, "min": 2,
               "max": 24},
    "token_lo": 3, "warmup_requests": 2, "warmup_output": 8,
    "check": {"tokens": 64, "requests": 6, "min_compared": 8},
}
CELL = "toy-sw.toy"


def _write(root, rel, text):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def _digest(d):
    h = hashlib.sha256()
    for p in sorted(d.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(d)).encode() + p.read_bytes())
    return h.hexdigest()


def test_a_family_enters_by_new_files(tmp_path, monkeypatch):
    _write(tmp_path, "families/windowed.py", FAMILY)
    _write(tmp_path, "kernels/local_prefill.py", KERNEL)
    _write(tmp_path, "metrics/graph_instances.py", METRIC)
    _write(tmp_path, "configs/toy-sw.json", json.dumps(CONFIG))
    _write(tmp_path, "traffic/toy.json", json.dumps(MIX))
    _write(tmp_path, f"cells/{CELL}.json", json.dumps({"rate": 8.0}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-sw", "source": "a test",
                             "file": "configs/toy-sw.json", "reduced": [],
                             "why": "a windowed family"})
    bench["workloads"].append({"name": CELL, "config": "toy-sw",
                               "traffic": "toy", "chips": 1,
                               "why": "a windowed family at a CPU size"})
    bench["per_layer"].append({"name": "graph_instances", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine", "moves": "output_tokens_s",
                               "workloads": [CELL]})
    _write(tmp_path, "BENCHMARK.json", json.dumps(bench))
    monkeypatch.setattr(files, "ROOTS", [tmp_path] + files.ROOTS)
    monkeypatch.setattr(files, "BENCHMARK", tmp_path / "BENCHMARK.json")

    harness = REPO / "ecobench" / "harness"
    before = _digest(harness)
    out = cpu_run(CELL, 2**31 + 41, 3.0, True, rate=8.0)
    assert _digest(harness) == before

    assert out["correct"] is True, out["checks"]
    assert out["checks"]["widest_logit_gap"]["value"] < 1e-3
    assert out["metrics"] == {"graph_instances": {"value": 2.0,
                                                  "unit": "count"}}
    run = out["run"]
    assert run.family.__name__ == "ecobench_families_windowed"
    assert run.model.window == 24
    # the windowed prefills of the window's last 15% are the new file's;
    # the dense file counts none of them
    calls = run.calls["local_prefill"]
    assert calls and all(f > 0 and b > 0 for f, b in calls)
    assert run.calls["flash_prefill"] == []
    assert any(e[0] == "run" and e[3] == "decode" for e in run.events)
