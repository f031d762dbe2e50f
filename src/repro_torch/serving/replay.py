"""Replay harness: drive tagged traces through the live serving stack.

The scheduling stack (``EcoServeSystem`` + ``SimulationEngine``) is shared
verbatim between the simulator and the real server; what changes is *who
executes the slots* and *whose clock the timeline follows*.  This module
supplies those two axes:

- ``VirtualClock`` / ``WallClock``: a virtual clock keeps the replay a
  deterministic discrete-event run (slot durations come from the
  executor model — bit-reproducible, used by the conformance suite); a
  wall clock sleeps until each event's timestamp (scaled by
  ``time_scale``) and folds real elapsed time back into the timeline.
- ``FakeEngine`` / ``RealEngineBackend``: a slot-for-slot stand-in that
  emits deterministic junk tokens (and can report a ``SyntheticTruth``
  model's timings into a CalibrationRecorder), and an adapter over the
  jax ``ServingEngine`` with the same run_prefill/run_decode/release
  protocol.
- ``ReplayEngine``: a ``SimulationEngine`` subclass that, at every slot
  completion, first lets the instance's attached backend actually
  execute the slot, reconciles engine-side early finishes (EOS, seq cap)
  with the scheduler's token accounting, then applies the normal
  completion path — so admission, routing and slot ordering are decided
  by exactly the code the simulator runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request
from repro_torch.simulator.engine import SimulationEngine


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """The slot geometry the fake backend and the scheduler need —
    duck-compatible with ``repro_torch.serving.engine.EngineConfig`` without
    the jax import the latter carries."""
    max_batch: int = 8
    max_seq_len: int = 256


# --------------------------------------------------------------------- #
class VirtualClock:
    """Deterministic clock: time is whatever the event loop says it is."""

    def __init__(self) -> None:
        self._now = 0.0

    def start(self) -> None:
        pass

    def now(self) -> float:
        return self._now

    def sleep_until(self, t: float) -> None:
        if t > self._now:
            self._now = t


class WallClock:
    """Real clock; ``time_scale`` > 1 stretches trace time (a 1 s gap in
    the trace takes ``time_scale`` wall seconds — slower than real time,
    useful to keep tiny CPU configs inside SLO), < 1 compresses it."""

    def __init__(self, time_scale: float = 1.0) -> None:
        self.time_scale = time_scale
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        if self._t0 is None:
            return 0.0
        return (time.perf_counter() - self._t0) / self.time_scale

    def sleep_until(self, t: float) -> None:
        # chunked sleeps so shutdown/interrupt stays responsive
        while True:
            dt = t - self.now()
            if dt <= 0:
                return
            time.sleep(min(dt * self.time_scale, 0.05))


# --------------------------------------------------------------------- #
def requests_from_trace(records: Sequence[dict], *, max_prompt: int,
                        max_output: int, vocab_size: Optional[int] = None,
                        seed: int = 0, limit: Optional[int] = None,
                        start_at_zero: bool = True) -> List[Request]:
    """Convert tagged trace records (``repro_torch.traces`` fixture schema:
    arrival_time / prompt_len / output_len [/ slo_class]) into engine-ready
    ``Request`` objects, clipping lengths to the engine's tiny config and
    synthesizing prompt token ids when ``vocab_size`` is given."""
    rng = np.random.default_rng(seed)
    recs = list(records)[:limit] if limit is not None else list(records)
    t0 = min((r["arrival_time"] for r in recs), default=0.0) \
        if start_at_zero else 0.0
    out: List[Request] = []
    for i, r in enumerate(recs):
        plen = max(1, min(int(r["prompt_len"]), max_prompt))
        olen = max(1, min(int(r["output_len"]), max_output))
        req = Request(rid=i, arrival_time=float(r["arrival_time"]) - t0,
                      prompt_len=plen, output_len=olen,
                      slo_class=r.get("slo_class") or "default")
        if vocab_size is not None:
            req.prompt_tokens = rng.integers(
                2, vocab_size - 1, size=plen).tolist()
        out.append(req)
    return out


# --------------------------------------------------------------------- #
class FakeEngine:
    """Deterministic stand-in for ``ServingEngine`` with the same slot
    discipline: one prefill lands one request in a slot, one decode step
    advances every occupied slot by one token.  Never emits EOS, so the
    scheduler's token accounting is the only finish criterion — which is
    what the conformance suite needs.  When ``true_model``/``recorder``
    are given, each op reports the model's timing as its 'measured' dt
    (the synthetic ground truth the calibration golden is fitted on)."""

    def __init__(self, econf, true_model=None, recorder=None):
        self.econf = econf
        B = econf.max_batch
        self.slot_req: List[Optional[Request]] = [None] * B
        self.lengths = np.zeros(B, np.int32)
        self.true_model = true_model
        self.recorder = recorder

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def run_prefill(self, reqs: List[Request]) -> None:
        for req in reqs:
            slots = self.free_slots()
            assert slots, "no free decode slot"
            slot = slots[0]
            self.slot_req[slot] = req
            self.lengths[slot] = req.prompt_len
            req.generated = [2 + req.rid % 97]
            if self.recorder is not None and self.true_model is not None:
                self.recorder.record_prefill(
                    req.prompt_len,
                    self.true_model.prefill_time([req.prompt_len]))

    def run_decode(self, reqs: List[Request]) -> List[Request]:
        """One decode iteration; returns requests the *engine* freed
        early (seq cap) that the scheduler still thinks are running."""
        occupied = [i for i, r in enumerate(self.slot_req)
                    if r is not None]
        if not occupied:
            return []
        ctx_sum = int(sum(self.lengths[i] for i in occupied))
        if self.recorder is not None and self.true_model is not None:
            self.recorder.record_decode(
                len(occupied), ctx_sum,
                self.true_model.decode_time(len(occupied),
                                            ctx_sum=ctx_sum))
        early: List[Request] = []
        for i in occupied:
            req = self.slot_req[i]
            self.lengths[i] += 1
            req.generated.append(2 + (req.rid + len(req.generated)) % 97)
            done = (len(req.generated) >= req.output_len
                    or self.lengths[i] >= self.econf.max_seq_len - 1)
            if done:
                self.slot_req[i] = None
                self.lengths[i] = 0
                if len(req.generated) < req.output_len:
                    early.append(req)
        return early

    def release(self, req: Request) -> None:
        for i, r in enumerate(self.slot_req):
            if r is req:
                self.slot_req[i] = None
                self.lengths[i] = 0
                return


class RealEngineBackend:
    """run_prefill/run_decode/release adapter over the jax ServingEngine."""

    def __init__(self, engine):
        self.engine = engine

    @property
    def econf(self):
        return self.engine.econf

    @property
    def executor(self):
        return self.engine.executor

    def free_slots(self) -> List[int]:
        return self.engine.free_slots()

    def run_prefill(self, reqs: List[Request]) -> None:
        for req in reqs:
            self.engine.prefill(req)

    def run_decode(self, reqs: List[Request]) -> List[Request]:
        before = {id(r): r for r in self.engine.slot_req if r is not None}
        self.engine.decode_step()
        after = {id(r) for r in self.engine.slot_req if r is not None}
        # engine-freed requests that finished early (EOS / seq cap)
        return [r for rid_, r in before.items()
                if rid_ not in after and len(r.generated) < r.output_len]

    def release(self, req: Request) -> None:
        self.engine.release(req)


# --------------------------------------------------------------------- #
class ReplayEngine(SimulationEngine):
    """SimulationEngine that executes slots on each instance's attached
    engine backend (``inst.engine``) and paces the timeline by a clock.

    With a ``VirtualClock`` (the default when ``clock`` is None) and an
    analytic executor model, a replay is a plain discrete-event run plus
    real token generation — decision-for-decision identical to the
    simulator, which is the sim-to-real conformance property.  With a
    ``WallClock``, measured execution time that overruns the modeled slot
    duration pushes the timeline forward (never backward), so SLO math
    reflects reality.
    """

    def __init__(self, system, clock=None):
        super().__init__(system)
        self.clock = clock if clock is not None else VirtualClock()

    # ------------------------------------------------------------------ #
    def _complete_slot(self, inst, kind, reqs, t_end):
        backend = getattr(inst, "engine", None)
        if backend is not None and inst.alive:
            if kind == "prefill":
                backend.run_prefill(reqs)
            else:
                for r in backend.run_decode(reqs):
                    # engine finished early (EOS or per-slot seq cap):
                    # clamp the scheduler's target so both sides agree
                    # this request is done
                    r.output_len = len(r.generated)
            t_real = self.clock.now()
            if t_real > t_end:
                t_end = t_real
                self.now = t_real
        n0 = len(self.finished)
        super()._complete_slot(inst, kind, reqs, t_end)
        if backend is not None:
            # requests the scheduler finished that still hold an engine
            # slot (e.g. one-token outputs done at prefill)
            for r in self.finished[n0:]:
                backend.release(r)

    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request],
            horizon: float = float("inf")) -> List[Request]:
        arrivals = sorted(requests, key=lambda r: r.arrival_time)
        i, n = 0, len(arrivals)
        heap = self.heap
        self.clock.start()
        import heapq
        while True:
            t_arr = arrivals[i].arrival_time if i < n else None
            if heap and (t_arr is None or heap[0].time < t_arr):
                if heap[0].time > horizon:
                    break
                ev = heapq.heappop(heap)
                self.clock.sleep_until(ev.time)
                self.now = max(self.now, ev.time)
                ev.fn(*ev.args)
            elif t_arr is not None:
                if t_arr > horizon:
                    break
                self.clock.sleep_until(t_arr)
                self.now = max(self.now, t_arr)
                req = arrivals[i]
                i += 1
                trc = self.tracer
                if trc.enabled:
                    trc.arrive(self.now, req)
                self.system.submit(req, self.now, self)
            else:
                break
            if self.on_tick:
                self.on_tick(self.now)
        self._pump_stragglers(horizon)
        return self.finished

    def _pump_stragglers(self, horizon: float) -> None:
        """After the last event, requests can still sit in the system
        queue waiting for the timeout-forced admission to trip (in the
        simulator that deferral simply ends the run; a server must serve
        them).  Advance time to each pending forced-admission deadline
        and drain until the queue empties or stops making progress."""
        import heapq
        system = self.system
        queue = getattr(system, "queue", None)
        slo_set = getattr(system, "slo_set", None)
        factor = getattr(getattr(system, "admission", None),
                         "timeout_factor", None)
        if queue is None or slo_set is None or factor is None:
            return
        guard = 0
        while queue and guard < 10_000:
            guard += 1
            before = len(queue)
            t_force = min(r.arrival_time
                          + factor * slo_set.for_request(r).ttft
                          for r in queue)
            t = max(self.now, t_force) + 1e-9
            if t > horizon:
                return
            self.clock.sleep_until(t)
            self.now = max(self.now, t)
            system._drain_queue(self.now, self)
            while self.heap and self.heap[0].time <= horizon:
                ev = heapq.heappop(self.heap)
                self.clock.sleep_until(ev.time)
                self.now = max(self.now, ev.time)
                ev.fn(*ev.args)
            if len(queue) >= before:
                return
