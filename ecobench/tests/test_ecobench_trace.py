"""The trace's reduction on a hand-made chrome trace (µs)."""
import json

import pytest

from ecobench_testlib import REPO  # noqa: F401
from ecobench.harness import trace


def X(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    X("ecobench.window", "user_annotation", 1000, 1000),
    X("ecobench.decode", "user_annotation", 1000, 400),
    X("ecobench.kernel.decode_attention", "user_annotation", 1100, 50),
    X("cudaLaunchKernel", "cuda_runtime", 1120, 5, correlation=7),
    X("aten::mm", "cpu_op", 1200, 100),
    X("cudaLaunchKernel", "cuda_runtime", 1210, 5, correlation=8),
    X("ecobench.sleep", "user_annotation", 1500, 400),
    # device: attention kernel 1150-1250, matmul 1300-1500, a kernel
    # before the window (cut at its start), a copy at the end
    X("attn_kernel<128>", "kernel", 1150, 100, tid=7, correlation=7),
    X("gemm", "kernel", 1300, 200, tid=7, correlation=8),
    X("early", "kernel", 900, 150, tid=7, correlation=3),
    X("Memcpy DtoH", "gpu_memcpy", 1950, 100, tid=7),
]


def test_reduce_busy_kernels_and_gaps():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1e-3)
    # busy: 1000-1050 (early), 1150-1250, 1300-1500, 1950-2000
    assert r["busy_s"] == pytest.approx(400e-6)
    assert r["kernel_s"] == {"decode_attention": pytest.approx(100e-6)}
    ops = dict(r["device_ops"])
    assert ops["gemm"] == pytest.approx(200e-6)
    assert ops["early"] == pytest.approx(50e-6)
    gaps = dict(r["idle_gaps"])
    # 1050-1150 under decode (no op at 1100), 1250-1300 under decode >
    # aten::mm, 1500-1950 under sleep
    assert gaps["ecobench.sleep"] == pytest.approx(450e-6)
    assert gaps["ecobench.decode > aten::mm"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(600e-6)


def test_roofline_share():
    calls = [(0.0, 3.35e12 * 1e-4)]          # 100 µs of bytes at the rate
    assert trace.roofline(calls, 2e-4) == pytest.approx(50.0)
    assert trace.roofline([], 1.0) is None
    assert trace.roofline(calls, 0.0) is None


def test_read_file(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.read(str(p))["busy_s"] == pytest.approx(400e-6)


def test_no_window_span_is_an_error():
    with pytest.raises(ValueError):
        trace.reduce(EVENTS[1:])
