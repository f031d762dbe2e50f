"""The port's dry run (``repro_torch.launch.dryrun_lib``) on a fake 2x4
mesh against the reference's (``repro.launch.dryrun_lib`` on a 2x4 host
mesh of Auto axes), for ``tests/test_dryrun_small.py``'s four pairs; a
16x16 production-mesh run of one pair through the CLI; per-device
counting; and the kernels' meta path that the dry run runs through.

Each side runs in a subprocess with a timeout of its own: the reference
with 8 forced host devices, the port with the ``fake`` process group (the
test process starts none)."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
PAIRS = [("llama3-8b", "train_4k"),
         ("phi3.5-moe-42b-a6.6b", "decode_32k"),
         ("rwkv6-3b", "prefill_32k"),
         ("recurrentgemma-2b", "long_500k")]
# per-device FLOPs within 10% of the reference's on these two pairs
FLOPS_PAIRS = [("llama3-8b", "train_4k"), ("phi3.5-moe-42b-a6.6b",
                                           "decode_32k")]
FLOPS_RTOL = 0.10

REF_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.launch.dryrun_lib import run_dryrun
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, shape in json.loads(sys.argv[1]):
    r = run_dryrun(arch, shape, mesh=mesh)
    out[f"{arch}:{shape}"] = {"status": r["status"],
                              "flops": r.get("cost", {}).get(
                                  "flops_per_device"),
                              "error": r.get("error")}
print(json.dumps(out))
"""

PORT_SCRIPT = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.dryrun_lib import run_dryrun
from repro_torch.launch.mesh import init_fake_process_group
init_fake_process_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = {}
for arch, shape in json.loads(sys.argv[1]):
    r = run_dryrun(arch, shape, mesh=mesh)
    out[f"{arch}:{shape}"] = {
        "status": r["status"], "error": r.get("error"),
        "flops": r.get("cost", {}).get("flops_per_device"),
        "mesh": r["mesh"], "chips": r["chips"],
        "roofline": r.get("roofline"), "kernels": r.get("cost", {}).get(
            "kernels")}

# per-device counting: one column-parallel product on the mesh counts
# 1/8 of the whole product's FLOPs (batch over 2, columns over 4)
import torch
from repro_torch.models.layers import matmul
from repro_torch.models.spmd import P, place
from repro_torch.roofline.op_costs import OpCosts
x = place(torch.empty(8, 64, 256, device="meta"), P("data", None, None),
          mesh)
w = place(torch.empty(256, 512, device="meta"), P(None, "model"), mesh)
with OpCosts() as oc:
    y = matmul(x, w)
out["matmul"] = {"flops": oc.costs.flops, "global": 2.0 * 8 * 64 * 256 * 512,
                 "shard_dims": [getattr(p, "dim", None) for p in y.placements]}
print(json.dumps(out))
"""


def _run(script, arg, xla=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    if xla:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run([sys.executable, "-c", script, arg],
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    return _run(PORT_SCRIPT, json.dumps(PAIRS))


@pytest.fixture(scope="module")
def reference():
    return _run(REF_SCRIPT, json.dumps(FLOPS_PAIRS), xla=True)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_dryrun_runs_on_a_fake_2x4_mesh(port, arch, shape):
    r = port[f"{arch}:{shape}"]
    assert r["status"] == "ok", r["error"]
    assert r["mesh"] == "2x4" and r["chips"] == 8
    terms = r["roofline"]
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert min(terms[k] for k in ("compute_s", "memory_s",
                                  "collective_s")) >= 0
    assert r["flops"] > 0 and r["kernels"]


@pytest.mark.parametrize("arch,shape", FLOPS_PAIRS)
def test_per_device_flops_within_10pct_of_the_reference(port, reference,
                                                        arch, shape):
    want = reference[f"{arch}:{shape}"]
    assert want["status"] == "ok", want["error"]
    got = port[f"{arch}:{shape}"]["flops"]
    assert abs(got / want["flops"] - 1) <= FLOPS_RTOL, (got, want["flops"])


def test_op_costs_count_per_device(port):
    r = port["matmul"]
    assert r["flops"] == r["global"] / 8
    assert r["shard_dims"] == [0, 2]


def test_production_mesh_builds_through_the_cli(tmp_path):
    """One pair on the 16x16 production mesh (256 fake ranks) through
    ``python -m repro_torch.launch.dryrun``; the JSON it writes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-32b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[0])
    assert line["status"] == "ok" and line["mesh"] == "pod16x16"
    with open(tmp_path / "qwen1.5-32b_decode_32k_pod16x16_baseline.json") \
            as f:
        res = json.load(f)
    assert res["chips"] == 256
    assert res["roofline"]["dominant"] == line["dominant"]
    assert res["memory"]["fits_hbm"] == line["fits_hbm"]


def test_unroll_variant_is_refused_with_its_reason():
    """The reference's ``unroll`` variant swaps ``lax.scan`` over the
    layers for a Python loop; the port always loops in Python, so the dry
    run refuses the variant rather than report its baseline under that
    name."""
    from repro_torch.launch.dryrun_lib import run_dryrun
    from repro_torch.models.spmd import AbstractMesh
    mesh = AbstractMesh((2, 4), ("data", "model"))
    for variant in ("unroll", "fsdp+unroll"):
        r = run_dryrun("llama3-8b", "train_4k", mesh=mesh, variant=variant)
        assert r["status"] == "skipped" and r["variant"] == variant
        assert "always loops over its layers in Python" in r["reason"]


# --------------------------------------------------------------------- #
# the kernels' meta path
# --------------------------------------------------------------------- #
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("grad", [False, True])
def test_flash_prefill_meta_path_reports_its_work(grad):
    from repro_torch.kernels import _meta as M
    from repro_torch.kernels.flash_prefill import flash_prefill
    B, T, Hq, Hkv, D = 2, 100, 8, 2, 64
    q = _meta(B, T, Hq, D).requires_grad_(grad)
    k, v = _meta(B, T, Hkv, D), _meta(B, T, Hkv, D)
    seen = []
    M.SINKS.append(lambda *a: seen.append(a))
    try:
        with torch.set_grad_enabled(grad):
            out = flash_prefill(q, k, v, causal=True)
            if grad:
                out.sum().backward()
    finally:
        M.SINKS.pop()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"
    pairs = T * (T + 1) // 2
    assert seen[0] == ("flash_prefill", 4.0 * D * B * Hq * pairs,
                       2.0 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D))
    if grad:
        assert seen[-1][0] == "flash_prefill_bwd"
        assert seen[-1][1] == 10.0 * D * B * Hq * pairs
        assert q.grad.shape == q.shape
    assert M.attention_pairs(10, 10, True, 4, 0) == sum(
        min(i + 1, 4) for i in range(10))


def test_decode_and_scan_meta_paths_report_their_work():
    from repro_torch.kernels import _meta as M
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, work
    seen = []
    M.SINKS.append(lambda *a: seen.append(a))
    try:
        B, S, Hq, Hkv, D = 4, 256, 8, 2, 128
        o = decode_attention(_meta(B, Hq, D), _meta(B, S, Hkv, D),
                             _meta(B, S, Hkv, D),
                             _meta(B, dtype=torch.int32))
        assert o.shape == (B, Hq, D)
        assert seen[-1][:2] == ("decode_attention", 4.0 * Hq * D * B * S)
        h = rglru_scan(_meta(2, 50, 32, dtype=torch.float32),
                       _meta(2, 50, 32, dtype=torch.float32))
        assert h.shape == (2, 50, 32) and seen[-1][0] == "rglru_scan"
        x = _meta(2, 70, 4, 64, dtype=torch.float32)
        o, s = rwkv6_scan(x, x, x, x, _meta(4, 64, dtype=torch.float32))
        assert o.shape == x.shape and s.shape == (2, 4, 64, 64)
        assert seen[-1][1] == work(2, 70, 4, 64)[0][0]
    finally:
        M.SINKS.pop()
