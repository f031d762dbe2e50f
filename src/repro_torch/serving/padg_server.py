"""PaDG server: real-execution EcoServe over N engine-backed instances.

Counterpart of ``repro.serving.padg_server``.  The server IS the
simulator's scheduling stack: requests flow through an ``EcoServeSystem``
(Algorithm 1 routing over macro instances, Algorithm 2 admission
constraints, timeout-forced queueing) driven by a
``repro_torch.serving.replay.ReplayEngine`` — a ``SimulationEngine`` whose
slot completions additionally execute on each instance's attached engine
backend (the port's PyTorch ``ServingEngine`` or the deterministic
``FakeEngine``) and whose timeline can follow a wall clock.  Because both
stacks run the identical admission/routing/slot code, a served run and a
simulated run of the same trace make the same decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.instance import Instance
from repro_torch.core.mitosis import register_instance, unregister_instance
from repro_torch.core.padg_system import EcoServeSystem
from repro_torch.core.request import Request, RequestState
from repro_torch.core.slo import SLO
from repro_torch.obs.events import attach_tracer
from repro_torch.serving.replay import (FakeEngine, RealEngineBackend,
                                        ReplayEngine, VirtualClock,
                                        WallClock)


@dataclasses.dataclass
class ServeStats:
    finished: List[Request]
    rejected: List[Request] = dataclasses.field(default_factory=list)
    # scheduling-decision trace (serve(record_decisions=True)); None when
    # not recorded
    decisions: Optional[list] = None

    def summary(self) -> Dict[str, float]:
        """Latency summary; always emits the full key set (zeros when no
        request finished) so JSONL rows keep a stable schema."""
        import numpy as np
        done = self.finished
        ttft = np.array([r.ttft for r in done
                         if r.ttft is not None]) if done else np.array([])
        tpots = [r.avg_tpot for r in done if r.avg_tpot is not None]
        return {
            "finished": len(done),
            "rejected": len(self.rejected),
            "ttft_p50": float(np.percentile(ttft, 50)) if len(ttft) else 0.0,
            "ttft_p90": float(np.percentile(ttft, 90)) if len(ttft) else 0.0,
            "tpot_p50": float(np.percentile(tpots, 50)) if tpots else 0.0,
            "tokens": int(sum(r.tokens_generated for r in done)),
        }


class _SchedulerModel:
    """Cost-model facade the scheduling system sees: prefill predictions
    come from the live executor (measured or analytic), capacity from the
    engine's slotted KV geometry."""

    def __init__(self, executor, kv_capacity: int):
        self.executor = executor
        self._kv_capacity = kv_capacity

    def predict_prefill(self, prompt_len: int) -> float:
        if hasattr(self.executor, "predict_prefill"):
            return self.executor.predict_prefill(prompt_len)
        return self.executor.prefill_time([prompt_len])

    def kv_capacity_tokens(self) -> int:
        return self._kv_capacity


class RealEcoServeSystem(EcoServeSystem):
    """EcoServeSystem whose instances carry engine backends and the
    engine's physical slot geometry (``max_decode_batch`` /
    ``max_prefill_batch`` = the engine's slot count).  While a traced
    serve runs on a wall clock, ``spans`` (``serving.spans.ServeSpans``)
    records each submitted request that goes to the queue."""

    spans = None

    def __init__(self, executors, engines, econf, slo, scheduler_model,
                 **kw):
        # consumed by _make_instance, which runs inside super().__init__
        self._executors = executors
        self._engines = engines
        self._econf = econf
        super().__init__(scheduler_model, len(engines), slo, **kw)

    def _make_instance(self, iid: int) -> Instance:
        econf = self._econf
        inst = Instance(
            iid, self._executors[iid],
            kv_capacity_tokens=econf.max_batch * econf.max_seq_len,
            max_decode_batch=econf.max_batch,
            max_prefill_batch=econf.max_batch,
            slo_tpot=self.slo.tpot, slo_ttft=self.slo.ttft,
            slo_classes=self.slo_set)
        inst.engine = self._engines[iid]
        register_instance(inst)
        return inst

    def submit(self, req: Request, now: float, engine) -> None:
        super().submit(req, now, engine)
        if self.spans is not None and self.queue and self.queue[-1] is req:
            self.spans.refuse(self, req, now)


class PaDGServer:
    """Real-execution EcoServe server.

    ``backend="real"`` builds one PyTorch ``ServingEngine`` per instance,
    each with its own weights drawn from ``seed``, on ``device`` (default:
    ``econf.device``, which is ``cuda``); ``backend="fake"`` uses the
    deterministic ``FakeEngine`` (requires an explicit ``executor`` model
    — there is nothing to measure).
    """

    def __init__(self, cfg: Optional[ModelConfig], n_instances: int,
                 slo: SLO, econf=None, seed: int = 0,
                 backend: str = "real", executor=None, recorder=None,
                 true_model=None, device: Optional[str] = None):
        if econf is None:
            from repro_torch.serving.engine import EngineConfig
            econf = EngineConfig()
        if device is not None:
            econf = dataclasses.replace(econf, device=device)
        self.econf = econf
        self.slo = slo
        self._shutdown = False
        engines, executors = [], []
        for _ in range(n_instances):
            if backend == "real":
                from repro_torch.serving.engine import ServingEngine
                eng = ServingEngine(cfg, seed=seed, econf=econf,
                                    recorder=recorder)
                engines.append(RealEngineBackend(eng))
                executors.append(executor if executor is not None
                                 else eng.executor)
            elif backend == "fake":
                if executor is None:
                    raise ValueError(
                        "backend='fake' needs an explicit executor model")
                engines.append(FakeEngine(econf, true_model=true_model,
                                          recorder=recorder))
                executors.append(executor)
            else:
                raise ValueError(f"unknown backend {backend!r}")
        model = _SchedulerModel(executors[0],
                                econf.max_batch * econf.max_seq_len)
        self.system = RealEcoServeSystem(executors, engines, econf, slo,
                                         model)
        self.recorder = recorder
        self.finished: List[Request] = []

    @property
    def instances(self) -> List[Instance]:
        return self.system.instances

    # --------------------------------------------------------------- #
    def serve(self, requests: List[Request], time_scale: float = 1.0,
              clock=None, record_decisions: bool = False,
              horizon: float = float("inf"), tracer=None) -> ServeStats:
        """Serve a request trace.  ``time_scale`` > 1 stretches trace
        time on the default wall clock; pass a ``VirtualClock`` for a
        deterministic (conformance) replay.  ``tracer`` attaches a
        flight recorder (``repro_torch.obs.events.Tracer``) to the served
        run; on any clock but a ``VirtualClock`` it also gets the loop's
        own spans (``repro_torch.serving.spans``)."""
        usable = self.econf.max_seq_len - 2
        accepted, rejected = [], []
        for r in requests:
            if r.prompt_len > usable or r.prompt_len <= 0:
                r.state = RequestState.FAILED
                rejected.append(r)
            else:
                accepted.append(r)

        if clock is None:
            clock = WallClock(time_scale)
        spans = None
        if tracer is not None and not isinstance(clock, VirtualClock):
            from repro_torch.serving.spans import ServeSpans
            spans = clock = ServeSpans(tracer, clock, accepted)
            spans.install(self.system)
        engine = ReplayEngine(self.system, clock=clock)
        log: Optional[list] = [] if record_decisions else None
        if record_decisions:
            engine.decision_log = log
            self.system.decision_log = log
        if tracer is not None:
            attach_tracer(tracer, engine=engine, system=self.system)
            if self.recorder is not None:
                self.recorder.tracer = tracer
        try:
            finished = engine.run(accepted, horizon=horizon)
        finally:
            if record_decisions:
                engine.decision_log = None
                self.system.decision_log = None
            if spans is not None:
                spans.uninstall(self.system)
        self.finished.extend(finished)
        return ServeStats(list(finished), rejected=rejected, decisions=log)

    # --------------------------------------------------------------- #
    def shutdown(self) -> None:
        """Release the actor-registry entries taken in ``__init__`` (the
        mitosis registry is process-global; leaking entries across
        servers corrupts later registry-size accounting)."""
        if self._shutdown:
            return
        self._shutdown = True
        for inst in self.system.instances:
            unregister_instance(inst)

    def __enter__(self) -> "PaDGServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
