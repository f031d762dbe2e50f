"""The traced run: spans from the benchmark's side, a profiled sub-window,
and the trace's reduction to device busy time, kernel time by call site,
idle gaps by what the host was doing, and the program's own ranges.

Spans (``torch.profiler.record_function``), installed in the traced run
only:
  ``ecobench.window``            the profiled sub-window (the window's
                                 last ``1 - TRACE_FROM`` share);
  ``ecobench.sleep``             the loop inside ``sleep_until``;
  ``ecobench.prefill`` / ``ecobench.decode``   an engine's prefill, step;
  ``ecobench.kernel.<name>``     one call that the kernel file
                                 ``kernels/<name>.py`` counts, of the
                                 ``repro_torch.models.layers`` entry it
                                 names, with the call's operations and
                                 bytes from its shapes.
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

import numpy as np

from ecobench.harness import files, work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM = "repro_torch."         # the program's own ranges, kept by name


class Step:
    """The decode step under way, as a kernel file's ``work`` sees it: each
    slot's cached tokens (the engine's host ``lengths``) at its start."""

    def __init__(self):
        self.lengths = None
        self._rows: Dict[int, int] = {}

    def begin(self, lengths) -> None:
        self.lengths = lengths.copy()
        self._rows.clear()

    def valid_rows(self, S: int) -> int:
        """K/V rows the step reads in caches of ``S`` rows: min(length +
        1, S) over the slots (0 outside a decode step)."""
        if self.lengths is None:
            return 0
        if S not in self._rows:
            self._rows[S] = int(np.minimum(self.lengths + 1, S).sum())
        return self._rows[S]


class Shims:
    """Every kernel file's shim and the engine methods' spans."""

    def __init__(self):
        self.kernels = files.modules("kernels")
        self.calls: Dict[str, List[tuple]] = {k: [] for k in self.kernels}
        self.active = False          # record work only inside the sub-window
        self.step = Step()
        self._orig: List[tuple] = []     # (attr, function), as installed
        self._layers = None

    def install(self, engines) -> None:
        from torch.profiler import record_function
        import repro_torch.models.layers as layers
        self._layers = layers
        for name, kern in self.kernels.items():
            fn = getattr(layers, kern.ATTR)
            self._orig.append((kern.ATTR, fn))
            setattr(layers, kern.ATTR, self._shim(name, kern, fn))
        for eng in engines:
            prefill, step = eng.prefill, eng.decode_step

            def pre(req, _f=prefill):
                with record_function("ecobench.prefill"):
                    return _f(req)

            def dec(_f=step, _e=eng):
                self.step.begin(_e.lengths)
                with record_function("ecobench.decode"):
                    return _f()
            eng.prefill, eng.decode_step = pre, dec

    def uninstall(self) -> None:
        if self._layers is not None:
            for attr, fn in reversed(self._orig):
                setattr(self._layers, attr, fn)
            self._orig.clear()
            self._layers = None

    def _shim(self, name: str, kern, fn):
        from torch.profiler import record_function
        span = "ecobench.kernel." + name
        calls = self.calls[name]

        def shim(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            w = kern.work(args, kw, self.step)
            if w is None:
                return fn(*args, **kw)
            with record_function(span):
                out = fn(*args, **kw)
            calls.append(w)
            return out
        return shim


class SubWindow:
    """Counts the kernel files' calls from ``t_start`` on, switched on from
    the clock, and profiles that part into ``trace_path`` (None: no
    profiler, as on the CPU); ``end`` (after the window has closed: the
    profiler's stop and export take seconds) switches it off."""

    def __init__(self, t_start: float, shims: Shims,
                 trace_path: Optional[str]):
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
        if self.path is not None:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
            self._span = record_function("ecobench.window")
            self._span.__enter__()
        self.shims.active = True
        self.state = "on"

    def end(self) -> None:
        self.shims.active = False
        if self._prof is not None:
            import torch
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
    (the outermost ``ecobench.*`` span and the innermost host op).  For
    readers of the program's own ranges, in seconds from the sub-window's
    start: the busy stretches (``busy``) and every ``repro_torch.*``
    range by name (``ranges``; ``harness/program.py``)."""
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
    ranges = collections.defaultdict(list)
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
        elif cat == "user_annotation" and e["name"].startswith(PROGRAM):
            ranges[e["name"]].append(((ts - w0) * 1e-6,
                                      (ts + dur - w0) * 1e-6))
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
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)],
            "busy": [((s - w0) * 1e-6, (t - w0) * 1e-6) for s, t in busy],
            "ranges": dict(ranges)}


def read(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    return reduce(data["traceEvents"] if isinstance(data, dict) else data)


def roofline(calls: List[tuple], device_s: Optional[float]):
    """Share (%) of the bound over the device time, or None."""
    if not calls or not device_s:
        return None
    return 100.0 * sum(work.bound_s(f, b) for f, b in calls) / device_s
