"""The served loop's own spans on a wall clock: what each slot waited for
and ran, and why a submitted request queued.

``PaDGServer.serve(..., tracer=...)`` on any clock but a ``VirtualClock``
wraps, for the call, the loop's clock (``ServeSpans``) and each
instance's backend (``SpanBackend``), and has the system report
refusals.  Three tuples go on ``tracer.events`` (the bus's form; the
JSONL codec keeps a type outside its schema under ``args``):

``("run", t, iid, kind, n, t_end, exec_s, host_s)``
    a slot executed on instance ``iid``'s backend: loop time at its
    start, ``prefill`` or ``decode``, the requests in it, its modeled
    end, the seconds the backend took, and the seconds the engine's host
    spent enqueueing its steps (``ServingEngine.host_s``; None for a
    backend without it, such as ``FakeEngine``);
``("wait", t, slept_s, cause, iid, kind, target)``
    one sleep of the loop's clock (a ``sleep_until`` whose target lay
    ahead): loop time at its start, the seconds it took and why:
    ``slot`` (to the modeled end of instance ``iid``'s ``kind`` slot),
    ``arrival`` (to a request's due time) or ``forced`` (to a queued
    request's forced-admission deadline, where ``iid`` and ``kind`` are
    None, as for ``arrival``);
``("refuse", t, rid, [[iid, why], ...])``
    a submitted request went to the system queue: for each instance the
    first Algorithm 2 constraint that failed there
    (``first_failed_constraint``), or ``unreachable``.

While ``torch.profiler`` records, runs and waits also open
``record_function`` ranges ``repro_torch.run.<kind>`` and
``repro_torch.wait.<cause>``, so they sit in the device trace.
``tracer.meta["perf_counter_origin"]`` is the ``time.perf_counter()``
reading at loop time 0: a tuple's loop time plus it is the host's clock.
``tracer.meta["decode_graph"]`` maps each instance's ``iid`` to the
serve's own counts of its engine's decode graphs, ``{"captures": n,
"steps": n}`` (``ServingEngine.graph_captures`` / ``graph_steps``: steps
served by replay), or None for a backend without them (``FakeEngine``).

A wait's cause is known before it sleeps, so its range can carry it: the
loop sleeps once to each arrival, in order, and once to each slot's end,
which the tracer's ``slot`` span gives as ``t + dur``; any other target
is a forced-admission deadline.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch


def _recording() -> bool:
    return torch.autograd._profiler_enabled()


def first_failed_constraint(status, req, slo, predict_prefill, now: float,
                            *, expected_kv_tokens: Optional[int] = None,
                            conservative: bool = False) -> Optional[str]:
    """The first constraint of ``core.constraints.check_constraints``, in
    its order and arithmetic, that refuses ``req``: ``ttft``,
    ``tpot_slack`` (the running decodes' saved slack), ``tpot_batch``
    (the decode step with the request added) or ``kv``; None exactly
    when ``check_constraints`` admits it."""
    t_total = sum(predict_prefill(n) for n in status.pending_prefill_lens)
    t_total += predict_prefill(req.prompt_len)
    if t_total + max(0.0, now - req.arrival_time) > slo.ttft:
        return "ttft"
    saved = status.saved_tpots
    if saved:
        if conservative:
            if min(saved) < t_total:
                return "tpot_slack"
        elif sum(saved) / len(saved) < t_total:
            return "tpot_slack"
    if status.decode_iter_time_plus_one > min(slo.tpot,
                                              status.decode_tpot_floor):
        return "tpot_batch"
    want = expected_kv_tokens if expected_kv_tokens is not None else (
        req.prompt_len * 2)
    if want > status.kv_tokens_free:
        return "kv"
    return None


def _graph_counts(backend) -> Optional[Tuple[int, int]]:
    """(graph_captures, graph_steps) of a backend's engine, or None."""
    engine = getattr(backend, "engine", None)
    if not hasattr(engine, "graph_steps"):
        return None
    return engine.graph_captures, engine.graph_steps


class ServeSpans:
    """The loop's clock, wrapped: ``start`` / ``now`` / ``sleep_until``
    of the clock it is given, each sleep recorded with its cause."""

    def __init__(self, tracer, clock, requests):
        self.tracer = tracer
        self.events = tracer.events
        self.clock = clock
        self._arrivals = sorted(r.arrival_time for r in requests)
        self._next_arrival = 0
        self._ends: Dict[float, Tuple[int, str]] = {}   # modeled slot ends
        self._scanned = 0             # tracer events read for slot spans
        self._slot: Optional[tuple] = None   # (t_end, iid, kind) slept to
        self._graphs0: Dict[int, Optional[Tuple[int, int]]] = {}

    # ---------------- install for one serve --------------------------- #
    def install(self, system) -> None:
        self._graphs0 = {inst.iid: _graph_counts(inst.engine)
                         for inst in system.instances}
        for inst in system.instances:
            inst.engine = SpanBackend(inst.engine, inst.iid, self)
        system.spans = self

    def uninstall(self, system) -> None:
        graphs = {}
        for inst in system.instances:
            c0, c1 = self._graphs0.get(inst.iid), _graph_counts(inst.engine)
            graphs[inst.iid] = None if c0 is None or c1 is None else {
                "captures": c1[0] - c0[0], "steps": c1[1] - c0[1]}
            if isinstance(inst.engine, SpanBackend):
                inst.engine = inst.engine.backend
        self.tracer.meta["decode_graph"] = graphs
        system.spans = None

    # ---------------- the clock's protocol ---------------------------- #
    def start(self) -> None:
        self.clock.start()
        scale = getattr(self.clock, "time_scale", 1.0)
        self.tracer.meta["perf_counter_origin"] = (
            time.perf_counter() - self.clock.now() * scale)

    def now(self) -> float:
        return self.clock.now()

    def sleep_until(self, t: float) -> None:
        cause, iid, kind = self._cause(t)
        t0 = self.clock.now()
        if t <= t0:
            self.clock.sleep_until(t)
            return
        p0 = time.perf_counter()
        if _recording():
            from torch.profiler import record_function
            with record_function(f"repro_torch.wait.{cause}"):
                self.clock.sleep_until(t)
        else:
            self.clock.sleep_until(t)
        self.events.append(("wait", t0, time.perf_counter() - p0, cause,
                            iid, kind, t))

    def _cause(self, t: float):
        arr = self._arrivals
        if self._next_arrival < len(arr) and t == arr[self._next_arrival]:
            self._next_arrival += 1
            return "arrival", None, None
        events = self.events
        for i in range(self._scanned, len(events)):
            ev = events[i]
            if ev[0] == "slot":          # ("slot", t, iid, kind, dur, ...)
                self._ends[ev[1] + ev[4]] = (ev[2], ev[3])
        self._scanned = len(events)
        slot = self._ends.pop(t, None)
        if slot is None:
            return "forced", None, None
        self._slot = (t, *slot)
        return "slot", slot[0], slot[1]

    # ---------------- hooks of the backends and the system ------------ #
    def slot_end(self, iid: int, kind: str) -> Optional[float]:
        """The modeled end of the slot the loop last slept to, if it is
        ``iid``'s ``kind`` slot (the one now executing)."""
        s = self._slot
        return s[0] if s is not None and s[1:] == (iid, kind) else None

    def refuse(self, system, req, now: float) -> None:
        why = []
        for m in system.sched.macros:
            slo = m.slo_set.for_request(req)
            for inst in m.instances:
                if m.reachable is not None and not m.reachable(inst.iid,
                                                               now):
                    why.append([inst.iid, "unreachable"])
                    continue
                why.append([inst.iid, first_failed_constraint(
                    inst.status(now, slo.tpot), req, slo, m.predict_prefill,
                    now, conservative=m.conservative)])
        self.events.append(("refuse", now, req.rid, why))


class SpanBackend:
    """An instance's backend (``run_prefill`` / ``run_decode`` / the
    rest), each slot it runs recorded as a ``run`` tuple."""

    def __init__(self, backend, iid: int, spans: ServeSpans):
        self.backend = backend
        self.iid = iid
        self.spans = spans

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def run_prefill(self, reqs):
        return self._run("prefill", self.backend.run_prefill, reqs)

    def run_decode(self, reqs):
        return self._run("decode", self.backend.run_decode, reqs)

    def _run(self, kind, fn, reqs):
        spans = self.spans
        engine = getattr(self.backend, "engine", None)
        h0 = getattr(engine, "host_s", None)
        t = spans.clock.now()
        p0 = time.perf_counter()
        if _recording():
            from torch.profiler import record_function
            with record_function(f"repro_torch.run.{kind}"):
                out = fn(reqs)
        else:
            out = fn(reqs)
        exec_s = time.perf_counter() - p0
        host = None if h0 is None else engine.host_s - h0
        spans.events.append(("run", t, self.iid, kind, len(reqs),
                             spans.slot_end(self.iid, kind), exec_s, host))
        return out
