"""The system under test: ``repro_torch``'s PaDG server with real engines,
built for one cell, its weights replaced by the benchmark's, driven by
the benchmark's clock.

What the benchmark reads from the program: the ``Request`` times the
loop stamps (arrival, admission, first and second token, finish), the
tokens each engine served, and each engine's ``recorder`` hook
(``record_prefill(T, dt)``, ``record_decode(batch, ctx_sum, dt)``, host
clock after the argmax read).  Each engine gets a recorder of its own,
which also stamps the decode step's time on the requests in its slots:
the time of a request's latest token, which ``Request`` does not keep.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

from ecobench.harness.model import family_of
from ecobench.harness.traffic import Arrival


@dataclasses.dataclass
class Log:
    prefills: List[tuple] = dataclasses.field(default_factory=list)  # (T, dt)
    decodes: List[tuple] = dataclasses.field(default_factory=list)   # (b, ctx, dt)
    last_token: Dict[int, float] = dataclasses.field(default_factory=dict)

    def clear(self) -> None:
        self.prefills.clear()
        self.decodes.clear()
        self.last_token.clear()


class EngineRecorder:
    """The engine's ``recorder`` hook for one engine."""

    tracer = None          # the server sets this when it is given a tracer

    def __init__(self, engine, clock, log: Log):
        self.engine, self.clock, self.log = engine, clock, log

    def record_prefill(self, T: int, dt: float) -> None:
        self.log.prefills.append((T, dt))

    def record_decode(self, batch: int, ctx_sum: int, dt: float) -> None:
        self.log.decodes.append((batch, ctx_sum, dt))
        now = self.clock.now()
        for r in self.engine.slot_req:
            if r is not None:
                self.log.last_token[r.rid] = now


def port_config(conf: dict, m):
    """The port's configuration for this file, cut to ``m.layers``, after
    checking that its fields are the ones the file's family gives."""
    from repro_torch.configs import get_config
    cfg = get_config(conf["port_config"])
    # the cut in depth; tests at a tiny size cut the widths too
    cfg = dataclasses.replace(cfg, num_layers=m.layers,
                              **conf.get("port_overrides", {}))
    want = family_of(conf).port_fields(m)
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"{conf['port_config']}: the port's config differs "
                         f"from the file (port, file): {diff}")
    return cfg


def to_requests(arrivals: List[Arrival]):
    from repro_torch.core.request import Request
    out = []
    for a in arrivals:
        r = Request(rid=a.rid, arrival_time=a.arrival_time,
                    prompt_len=a.prompt_len, output_len=a.output_len)
        r.prompt_tokens = list(a.prompt_tokens)
        out.append(r)
    return out


def build(conf: dict, m, mix: dict, weights_fn, device: str,
          clock, log: Log, dtype):
    """The PaDG server of the cell, with the benchmark's weights.

    The server draws one set of weights per engine from its seed; those
    are dropped before ``weights_fn()`` draws the benchmark's, which every
    engine then serves (one copy).  Returns (server, weights)."""
    import torch
    from repro_torch.core.slo import SLO
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.padg_server import PaDGServer

    eng_conf = conf["engine"]
    cfg = port_config(conf, m)
    econf = EngineConfig(max_batch=eng_conf["max_batch"],
                         max_seq_len=eng_conf["max_seq_len"], dtype=dtype,
                         eos_token=eng_conf["eos_token_id"], greedy=True,
                         device=device)
    slo = SLO(ttft=mix["slo"]["ttft_s"], tpot=mix["slo"]["tpot_s"])
    server = PaDGServer(cfg, eng_conf["n_instances"], slo=slo, econf=econf,
                        backend="real")
    engines = [inst.engine.engine for inst in server.instances]
    for eng in engines:
        eng.params = None
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    w = weights_fn()
    params = family_of(conf).port_params(w, m)
    for eng in engines:
        eng.params = params
        eng.recorder = EngineRecorder(eng, clock, log)
    return server, w


def engines_of(server):
    return [inst.engine.engine for inst in server.instances]


def prime(engine, arrivals: List[Arrival]) -> None:
    """Run the port's model once at each warm-up prompt and one decode step
    over the engine's slots, outside the engine, before anything is
    served.  A process's first calls (the kernels' build and load,
    cuBLAS's set-up, lazy module loads) take seconds; an engine that timed
    them would fold them into its executor's gains, and the scheduler
    would then hold requests on predictions many times too long."""
    import torch
    from repro_torch.models import forward
    B = engine.econf.max_batch
    with torch.no_grad():
        for a in arrivals:
            toks = torch.tensor([a.prompt_tokens], device=engine.device)
            logits, _ = forward(engine.params, engine.cfg, {"tokens": toks},
                                return_cache=True, last_only=True)
            int(logits[0, -1].argmax())
        # every slot is free: the step writes row 0 of each, which a
        # prefill overwrites, and reads that row alone
        lengths = torch.zeros(B, dtype=torch.long, device=engine.device)
        logits, _ = forward(engine.params, engine.cfg,
                            {"tokens": engine.tokens}, cache=engine.cache,
                            cache_len=lengths)
        logits.argmax(-1).tolist()


def warm_engines(engines, arrivals: List[Arrival], steps: int) -> None:
    """Each engine prefills the warm-up prompts and decodes ``steps``
    tokens through its own ``prefill`` and ``decode_step``, so that every
    instance's executor, not only the one Algorithm 1's sticky routing
    hands the warm-up serve, opens the window with measured gains."""
    for eng in engines:
        reqs = to_requests(arrivals)
        for r in reqs:
            r.output_len = steps + 1
            eng.prefill(r)
        for _ in range(steps):
            eng.decode_step()
        for r in reqs:
            eng.release(r)
