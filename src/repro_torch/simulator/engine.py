"""Discrete-event simulation engine.

Drives any ``ServingSystem`` (PaDG / NoDG / FuDG variants): request
arrivals, instance slot completions, and link transfers share one event
timeline.  Instances execute uninterruptible slots (prefill batch or
decode iteration); systems decide routing and what happens at slot
boundaries.

Arrivals are fed lazily from the (time-sorted) request list instead of
pre-pushing one heap event per request: the heap only ever holds in-flight
completions/transfers, and no per-request closure is allocated.  Ties are
resolved exactly as the old pre-pushed encoding did — an arrival at time t
fires before any completion scheduled at the same t (arrivals used to
carry the lowest sequence numbers), and equal-time arrivals fire in
request-list order (stable sort).  Slot completions are dispatched through
one engine method with an argument tuple stored on the event, not a fresh
closure capturing per-request state.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.instance import Instance
from repro_torch.core.request import Request
from repro_torch.core.system import ServingSystem  # noqa: F401  (re-export: the
# formal protocol moved to repro_torch.core.system; engine callers keep working)
from repro_torch.obs.events import NULL_TRACER, attach_decision_log


class Link:
    """FIFO bandwidth resource (NIC / PCIe); serializes transfers."""

    def __init__(self, name: str, bandwidth: float, latency: float = 1e-3):
        self.name = name
        self.bandwidth = bandwidth
        self.latency = latency
        self.busy_until = 0.0
        self.bytes_moved = 0.0

    def transfer(self, nbytes: float, now: float, factor: float = 1.0,
                 extra_latency: float = 0.0) -> float:
        """Occupy the link for one message; ``factor`` divides the rated
        bandwidth and ``extra_latency`` adds propagation delay (the
        transport's network-degradation path; defaults are the clean
        link, bit-identical to the historic two-argument form)."""
        start = max(now, self.busy_until)
        done = (start + self.latency + extra_latency
                + factor * (nbytes / self.bandwidth))
        self.busy_until = done
        self.bytes_moved += nbytes
        return done


@dataclasses.dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = dataclasses.field(compare=False)
    args: Tuple = dataclasses.field(compare=False, default=())


class SimulationEngine:
    # Flight-recorder hook (repro_torch.obs): NULL_TRACER keeps the hot path
    # allocation-free — every emission site is guarded by one attribute
    # read.  ``attach_tracer`` swaps in a live Tracer.
    tracer = NULL_TRACER
    _decision_log: Optional[List] = None

    @property
    def decision_log(self) -> Optional[List]:
        """Compat shim for the PR 8 scheduling-decision trace: attaching
        a list here installs it as a tracer mirror, so ``activate``
        appends the historic ("slot", t_start, iid, kind, duration,
        (rids...)) tuples through the event bus.  Shared with
        ``PolicySystemBase.decision_log`` so admission and slot events
        interleave into one totally ordered sequence."""
        return self._decision_log

    @decision_log.setter
    def decision_log(self, log: Optional[List]) -> None:
        attach_decision_log(self, log)

    def __init__(self, system: ServingSystem):
        self.system = system
        self.heap: List[_Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self._executing: Dict[int, bool] = {}
        self.finished: List[Request] = []
        self.on_tick: Optional[Callable[[float], None]] = None

    # ------------------------------------------------------------------ #
    def push(self, t: float, fn: Callable) -> None:
        heapq.heappush(self.heap, _Event(t, next(self._seq), fn))

    def push_call(self, t: float, fn: Callable, *args) -> None:
        """Schedule ``fn(*args)`` at time ``t`` without a closure."""
        heapq.heappush(self.heap, _Event(t, next(self._seq), fn, args))

    def activate(self, inst: Instance) -> None:
        """Ensure the instance is executing a slot (idempotent)."""
        if not inst.alive:
            return
        if self._executing.get(inst.iid):
            return
        kind, dur, reqs = inst.next_slot(self.now)
        if kind == "idle":
            return
        trc = self.tracer
        if trc.enabled:
            trc.slot(self.now, inst, kind, dur, reqs,
                     len(getattr(self.system, "queue", ())))
        self._executing[inst.iid] = True
        t_end = self.now + dur
        self.push_call(t_end, self._complete_slot, inst, kind, reqs, t_end)

    def _complete_slot(self, inst: Instance, kind: str,
                       reqs: List[Request], t_end: float) -> None:
        self._executing[inst.iid] = False
        if not inst.alive:
            # the instance died mid-slot (repro_torch.faults): the slot's work
            # is lost with its KV — the fault path already re-routed the
            # affected requests, so applying completion here would corrupt
            # their (possibly re-running) state and the dead instance's
            # aggregates
            return
        trc = self.tracer
        if kind == "prefill" and not inst.decode_here:
            # FuDG prefill instance: mark first token, hand off
            inst.handoff_prefilled(reqs, t_end)
            if trc.enabled:
                trc.handoff(t_end, inst.iid, reqs)
            self.system.on_slot_end(inst, "prefill_handoff", reqs,
                                    self.now, self)
        else:
            done = inst.complete_slot(kind, reqs, t_end)
            self.finished.extend(done)
            if trc.enabled and done:
                for r in done:
                    trc.finish(t_end, r.rid)
            self.system.on_slot_end(inst, kind, reqs, self.now, self)
        self.activate(inst)

    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request], horizon: float) -> List[Request]:
        # stable sort == (arrival_time, original index): the exact total
        # order the old per-request heap events produced
        arrivals = sorted(requests, key=lambda r: r.arrival_time)
        i, n = 0, len(arrivals)
        heap = self.heap
        while True:
            t_arr = arrivals[i].arrival_time if i < n else None
            if heap and (t_arr is None or heap[0].time < t_arr):
                ev = heapq.heappop(heap)
                if ev.time > horizon:
                    break
                self.now = ev.time
                ev.fn(*ev.args)
            elif t_arr is not None:
                # t_arr <= next event time: arrivals win ties
                if t_arr > horizon:
                    break
                self.now = t_arr
                req = arrivals[i]
                i += 1
                trc = self.tracer
                if trc.enabled:
                    trc.arrive(t_arr, req)
                self.system.submit(req, self.now, self)
            else:
                break
            if self.on_tick:
                self.on_tick(self.now)
        return self.finished
