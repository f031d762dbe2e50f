"""The flight-recorder event bus: typed sim-time events, zero overhead
when off.

One ``Tracer`` rides the whole stack: the engine emits slot spans (with
the per-instance state sampled at the slot boundary), ``PolicySystemBase``
emits the request lifecycle (arrive / admit / enqueue / drain / finish /
fail / requeue / migrate), the macro scheduler emits rolling-activation
rotations and mitosis split/merge, the transport emits per-message fates,
the fault injector and control loop emit their domain events, and the
real-path ``CalibrationRecorder`` emits per-op timings.  Everything is a
plain tuple ``(etype, t, ...)`` appended to ``tracer.events`` — no
classes, no dict churn on the hot path; the positional field names live
in ``repro_torch.obs.export.SCHEMA``.

The default is ``NULL_TRACER`` (``enabled = False``): every emission site
guards with one attribute read (``trc = self.tracer; if trc.enabled:``),
the same contract as the pre-existing ``decision_log: None`` pattern —
which this layer subsumes: attaching a list to
``engine.decision_log`` / ``system.decision_log`` installs a
mirror-only tracer that appends the exact legacy
``("slot"|"admit"|"queue"|"drain", ...)`` tuples, so the sim-to-real
conformance suite observes a bit-identical totally ordered sequence.

This module is deliberately import-free of the rest of ``repro`` so the
engine/system/transport hot paths can import it without cycles.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


class NullTracer:
    """The off switch: one shared instance, ``enabled`` False, and inert
    emission methods (never called on guarded hot paths; the methods
    exist so unguarded cold paths cannot crash)."""

    enabled = False
    events: Tuple = ()
    clock: Optional[Callable[[], float]] = None

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._noop

    @staticmethod
    def _noop(*args: Any, **kw: Any) -> None:
        return None

    def now(self) -> float:
        return -1.0


NULL_TRACER = NullTracer()


class Tracer:
    """Collects typed events with sim-time timestamps and stable ids.

    ``mirror`` (optional) is a legacy ``decision_log`` list: the four
    decision kinds are additionally appended to it in their historical
    tuple shapes.  ``record=False`` makes a mirror-only tracer (the
    ``decision_log`` compat shim) that never accumulates ``events``.
    ``clock`` supplies timestamps for control-plane emissions that have
    no sim time in scope (mitosis split/merge); ``run_once`` wires it to
    the engine clock, bare construction stamps ``-1.0``.
    """

    enabled = True

    __slots__ = ("events", "_mirror", "_record", "clock", "meta")

    def __init__(self, mirror: Optional[list] = None, record: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        self.events: List[tuple] = []
        self._mirror = mirror
        self._record = record
        self.clock = clock
        self.meta: dict = {}

    def now(self) -> float:
        """Clock fallback for emissions without a timestamp in scope."""
        return self.clock() if self.clock is not None else -1.0

    # ---------------- request lifecycle -------------------------------- #
    def arrive(self, t: float, req) -> None:
        if self._record:
            self.events.append(("arrive", t, req.rid, req.slo_class,
                                req.model))

    def admit(self, t: float, rid: int, iid: int) -> None:
        if self._mirror is not None:
            self._mirror.append(("admit", t, rid, iid))
        if self._record:
            self.events.append(("admit", t, rid, iid))

    def enqueue(self, t: float, rid: int) -> None:
        if self._mirror is not None:
            self._mirror.append(("queue", t, rid))
        if self._record:
            self.events.append(("enqueue", t, rid))

    def drain(self, t: float, rid: int, iid: int) -> None:
        if self._mirror is not None:
            self._mirror.append(("drain", t, rid, iid))
        if self._record:
            self.events.append(("drain", t, rid, iid))

    def finish(self, t: float, rid: int) -> None:
        if self._record:
            self.events.append(("finish", t, rid))

    def fail(self, t: float, rid: int, reason: str) -> None:
        if self._record:
            self.events.append(("fail", t, rid, reason))

    def requeue(self, t: float, rid: int) -> None:
        if self._record:
            self.events.append(("requeue", t, rid))

    def migrate(self, t: float, rid: int, src: int, dst: int) -> None:
        if self._record:
            self.events.append(("migrate", t, rid, src, dst))

    def handoff(self, t: float, iid: int, reqs) -> None:
        if self._record:
            self.events.append(("handoff", t, iid,
                                tuple(r.rid for r in reqs)))

    # ---------------- slot spans (per-instance state sample) ----------- #
    def slot(self, t: float, inst, kind: str, dur: float, reqs,
             queue_len: int) -> None:
        # the busiest emission (one per slot), most of the
        # tracing-overhead budget benchmarks/bench_simspeed.py gates.
        # The hot path stores the live request batch and defers rid
        # extraction to analysis time (``slot_rids``): the engine's slot
        # batches are fresh slices that are never mutated after the
        # slot is scheduled, and rids are immutable, so the deferred
        # view is identical — without an O(batch) tuple build per slot.
        m = self._mirror
        if m is not None:
            # the exact legacy decision_log tuple, at the exact legacy
            # program point (the caller emits before scheduling the slot)
            rids = tuple([r.rid for r in reqs])
            m.append(("slot", t, inst.iid, kind, dur, rids))
            reqs = rids
        if self._record:
            # _pending_tokens/_decode_kv_sum are Instance's O(1) running
            # aggregates (kv_tokens_used() == their sum); read directly
            # to skip property/method dispatch on the hot path
            pending_tokens = inst._pending_tokens
            self.events.append((
                "slot", t, inst.iid, kind, dur, reqs,
                inst._decode_kv_sum + pending_tokens,
                inst.kv_capacity_tokens,
                len(inst.pending), pending_tokens,
                len(inst.decoding), queue_len, inst.max_decode_batch))

    # ---------------- instance / fault / control / transport ----------- #
    def instance(self, t: float, iid: int, what: str) -> None:
        if self._record:
            self.events.append(("instance", t, iid, what))

    def fault(self, t: float, kind: str, iid) -> None:
        if self._record:
            self.events.append(("fault", t, kind, iid))

    def control(self, t: float, what: str, value) -> None:
        if self._record:
            self.events.append(("control", t, what, value))

    def transport(self, t: float, what: str, kind: str, src: int,
                  dst: int) -> None:
        if self._record:
            self.events.append(("transport", t, what, kind, src, dst))

    # ---------------- real-path op samples (calibration bus) ----------- #
    def op(self, t: float, what: str, work: int, extra: int,
           dt: float) -> None:
        if self._record:
            self.events.append(("op", t, what, work, extra, dt))


def slot_rids(field) -> Tuple[int, ...]:
    """Normalize a slot/handoff event's request field to a rid tuple.
    Live tracers store the request batch itself (hot-path economy, see
    ``Tracer.slot``); mirror-attached tracers and JSONL round trips
    store int tuples already."""
    if field and not isinstance(field[0], int):
        return tuple([r.rid for r in field])
    return tuple(field)


# --------------------------------------------------------------------- #
# attachment helpers
# --------------------------------------------------------------------- #
def attach_decision_log(obj, log: Optional[list]) -> None:
    """The ``decision_log`` compat shim body: property setters on
    ``SimulationEngine`` / ``PolicySystemBase`` delegate here.

    Attaching a list installs it as the mirror of the object's tracer —
    minting a mirror-only tracer when tracing is off, so the legacy
    contract (None default = allocation-free hot path) survives.
    Detaching (``log = None``) removes the mirror and drops a shim-only
    tracer back to ``NULL_TRACER``."""
    obj._decision_log = log
    trc = getattr(obj, "tracer", NULL_TRACER)
    if log is not None:
        if trc.enabled:
            trc._mirror = log
        else:
            obj.tracer = Tracer(mirror=log, record=False)
    elif trc.enabled:
        trc._mirror = None
        if not trc._record:
            obj.tracer = NULL_TRACER


def attach_tracer(tracer: Tracer, engine=None, system=None) -> Tracer:
    """Thread one tracer through a live (engine, system) pair: the
    engine (slot spans + clock), the system (request lifecycle), its
    transport, its macro scheduler and macros (rotate/split/merge), and
    — for composite fleet systems — every member pool the same way.
    Purely attribute assignment: attaching is observation-only and never
    perturbs the event timeline."""
    if engine is not None:
        engine.tracer = tracer
        if tracer.clock is None:
            tracer.clock = lambda: engine.now
        # keep a previously attached decision_log mirrored through the
        # replacement tracer (run_once tracing + conformance recording)
        if getattr(engine, "_decision_log", None) is not None:
            tracer._mirror = engine._decision_log

    def _wire(sys_obj) -> None:
        sys_obj.tracer = tracer
        tr = getattr(sys_obj, "transport", None)
        if tr is not None:
            tr.tracer = tracer
        sched = getattr(sys_obj, "sched", None)
        if sched is not None:
            sched.tracer = tracer
            for m in getattr(sched, "macros", ()):
                m.tracer = tracer

    if system is not None:
        _wire(system)
        for pool in getattr(system, "pools", ()) or ():
            _wire(pool)
    return tracer
