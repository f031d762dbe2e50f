"""The traced run: spans from the benchmark's side, a profiled sub-window,
and the trace's reduction to device busy time, kernel time by call site,
and idle gaps by what the host was doing.

Spans (``torch.profiler.record_function``), installed in the traced run
only:
  ``ecobench.window``            the profiled sub-window (the window's
                                 last ``1 - TRACE_FROM`` share);
  ``ecobench.sleep``             the loop inside ``sleep_until``;
  ``ecobench.prefill`` / ``ecobench.decode``   an engine's prefill, step;
  ``ecobench.kernel.<name>``     one call of the port's kernel entry
                                 ``<name>`` (a shim over
                                 ``repro_torch.models.layers``' names),
                                 which also records the call's operations
                                 and bytes from its shapes.
A kernel launched inside a ``ecobench.kernel.<name>`` span is that call's
(the launch's correlation id ties the device kernel to the host's launch
inside the span), whatever the kernel is called.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
from typing import Dict, List, Optional

from ecobench.harness import work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SHIMS = {"flash_prefill": "flash_prefill_op",
         "decode_attention": "decode_attention_op"}


class Shims:
    """The kernel entries' shims and the engine methods' spans."""

    def __init__(self):
        self.calls: Dict[str, List[tuple]] = {k: [] for k in SHIMS}
        self.active = False          # record work only inside the sub-window
        self.valid_rows = 0          # K/V rows of the current decode step
        self._orig = {}
        self._layers = None

    def install(self, engines, max_seq_len: int) -> None:
        import numpy as np
        from torch.profiler import record_function
        import repro_torch.models.layers as layers
        self._layers = layers
        for name, attr in SHIMS.items():
            self._orig[attr] = getattr(layers, attr)
        layers.flash_prefill_op = self._flash_prefill
        layers.decode_attention_op = self._decode_attention
        for eng in engines:
            prefill, step = eng.prefill, eng.decode_step

            def pre(req, _f=prefill):
                with record_function("ecobench.prefill"):
                    return _f(req)

            def dec(_f=step, _e=eng):
                self.valid_rows = int(np.minimum(_e.lengths + 1,
                                                 max_seq_len).sum())
                with record_function("ecobench.decode"):
                    return _f()
            eng.prefill, eng.decode_step = pre, dec

    def uninstall(self) -> None:
        if self._layers is not None:
            for attr, fn in self._orig.items():
                setattr(self._layers, attr, fn)
            self._layers = None

    def _flash_prefill(self, q, k, v, **kw):
        fn = self._orig["flash_prefill_op"]
        if not self.active or kw.get("window", 0):
            return fn(q, k, v, **kw)
        from torch.profiler import record_function
        B, T, Hq, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        with record_function("ecobench.kernel.flash_prefill"):
            out = fn(q, k, v, **kw)
        self.calls["flash_prefill"].append(work.flash_prefill_work(
            B, T, S, Hq, Hkv, D, q.element_size(), kw.get("q_offset", 0)))
        return out

    def _decode_attention(self, q, k_cache, v_cache, lengths):
        fn = self._orig["decode_attention_op"]
        if not self.active:
            return fn(q, k_cache, v_cache, lengths)
        from torch.profiler import record_function
        B, Hq, D = q.shape
        Hkv = k_cache.shape[2]
        with record_function("ecobench.kernel.decode_attention"):
            out = fn(q, k_cache, v_cache, lengths)
        self.calls["decode_attention"].append(work.decode_attention_work(
            B, Hq, Hkv, D, self.valid_rows, q.element_size()))
        return out


class SubWindow:
    """Profiles the window from ``t_start`` on, switched on from the clock;
    ``end`` (after the window has closed: the profiler's stop and export
    take seconds) switches it off."""

    def __init__(self, t_start: float, shims: Shims, trace_path: str):
        self.t_start = t_start
        self.shims = shims
        self.path = trace_path
        self.state = "before"
        self._prof = None
        self._span = None

    def __call__(self, t: float) -> None:
        if self.state == "before" and t >= self.t_start:
            self.begin()

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function("ecobench.window")
        self._span.__enter__()
        self.shims.active = True
        self.state = "on"

    def end(self) -> None:
        import torch
        self.shims.active = False
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.state = "done"

    def sleep_span(self):
        if self.state != "on":
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function("ecobench.sleep")


def warm_profiler(device) -> None:
    """Start and stop a profiler once around one small kernel (set-up):
    CUPTI's first start is slow, and that cost stays out of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=device).sum().item()


# --------------------------------------------------------------------- #
def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events: List[dict], top: int = 10) -> dict:
    """Reduce a chrome trace's events (µs) to seconds: the sub-window's
    length, device busy time (union of kernels, copies and sets inside it),
    device time of the kernels launched inside each
    ``ecobench.kernel.<name>`` span, the device operations that took most
    time, and idle gaps summed by what the host was doing at their middle
    (the outermost ``ecobench.*`` span and the innermost host op)."""
    win = [e for e in events if e.get("name") == "ecobench.window"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no ecobench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    dev = []
    by_op = collections.Counter()
    launch_ts = {}
    spans = collections.defaultdict(list)
    host = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                dev.append((s, t))
                by_op[e["name"][:120]] += (t - s) * 1e-6
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        if e.get("tid") == tid and cat in ("user_annotation", "cpu_op"):
            name = e["name"]
            if cat == "user_annotation" and name.startswith(
                    "ecobench.kernel."):
                spans[name[len("ecobench.kernel."):]].append((ts, ts + dur))
            if name != "ecobench.window":
                host.append((ts, ts + dur, name))
    busy = _union(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6

    kernel_s = {}
    for name, iv in spans.items():
        iv.sort()
        starts = [s for s, _ in iv]
        tot = 0.0
        for e in events:
            if e.get("cat") != "kernel" or e.get("ph") != "X":
                continue
            corr = (e.get("args") or {}).get("correlation")
            t = launch_ts.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                tot += float(e["dur"]) * 1e-6
        kernel_s[name] = tot

    gaps = []
    prev = w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = collections.Counter()
    host.sort(key=lambda h: (h[0], -h[1]))
    stack: List[tuple] = []
    j = 0
    for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + t)
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        stack = [h for h in stack if h[1] >= mid]
        outer = next((h[2] for h in stack if h[2].startswith("ecobench.")),
                     "loop")
        inner = stack[-1][2] if stack else "loop"
        name = outer if inner == outer else f"{outer} > {inner}"
        idle[name] += (t - s) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernel_s": kernel_s,
            "device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}


def read(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    return reduce(data["traceEvents"] if isinstance(data, dict) else data)


def roofline(calls: List[tuple], device_s: Optional[float]):
    """Share (%) of the bound over the device time, or None."""
    if not calls or not device_s:
        return None
    return 100.0 * sum(work.bound_s(f, b) for f, b in calls) / device_s
