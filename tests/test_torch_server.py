"""The port's PaDG server against the JAX package on the CPU.

Decisions: ``PaDGServer(backend="real", device="cpu")`` with a fitted
executor on a virtual clock makes the same totally ordered scheduling
decisions, and finishes each request at the same time, as the JAX
``SimulationEngine`` on the requests of ``test_sim_real_conformance.py``
(the port's engines generate real tokens meanwhile).

Tokens: on the same (bridged) weights the port's real server emits the
same tokens per request as the JAX real server, for llama3-8b, rwkv6-3b
and recurrentgemma-2b (one full cycle, with a window that the longer
prompts and their outputs overrun, so the local k/v ring wraps).
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.padg_system import EcoServeSystem  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.slo import SLO as JSLO  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.padg_server import PaDGServer as JPaDGServer  # noqa: E402
from repro.serving.replay import VirtualClock as JVirtualClock  # noqa: E402
from repro.simulator.cost_model import FittedExecutor as JFitted  # noqa: E402
from repro.simulator.engine import SimulationEngine  # noqa: E402
from repro.traces import load_fixture, normalize_rate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.padg_server import PaDGServer  # noqa: E402
from repro_torch.serving.replay import (VirtualClock,  # noqa: E402
                                        requests_from_trace)
from repro_torch.simulator.cost_model import FittedExecutor  # noqa: E402

B, S = 4, 160
VOCAB = 300
SLO_KW = dict(ttft=0.5, tpot=0.05)
MODEL_KW = dict(prefill_base=1e-3, prefill_per_token=1e-4, decode_base=5e-4,
                decode_per_seq=2e-4, decode_per_ctx_token=1e-6,
                kv_capacity=B * S)


ARCH_KW = {"recurrentgemma-2b": dict(num_layers=3, sliding_window=16)}


def tiny_cfg(make=get_smoke_config, arch="llama3-8b"):
    cfg = make(arch)
    kw = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
              head_dim=64, d_ff=256, vocab_size=VOCAB)
    return dataclasses.replace(cfg, **{**kw, **ARCH_KW.get(arch, {})})


def poisson_requests(make, n=30, seed=7, mean_gap=0.02):
    """test_sim_real_conformance.poisson_requests, with prompt tokens."""
    rng = np.random.default_rng(seed)
    tok_rng = np.random.default_rng(seed + 1)
    reqs, t = [], 0.0
    for i in range(n):
        plen = int(rng.integers(3, 60))
        reqs.append(make(rid=i, arrival_time=t, prompt_len=plen,
                         output_len=int(rng.integers(1, 12)),
                         prompt_tokens=tok_rng.integers(
                             2, VOCAB - 1, plen).tolist()))
        t += float(rng.exponential(mean_gap))
    return reqs


def trace_requests(make):
    """test_sim_real_conformance.trace_requests, with prompt tokens."""
    records = []
    for name in ("azure", "burstgpt"):
        records.extend(normalize_rate(load_fixture(name), 12.0)[:15])
    reqs = requests_from_trace(records, max_prompt=S - 40, max_output=10,
                               vocab_size=VOCAB, seed=0)
    return [make(rid=r.rid, arrival_time=r.arrival_time,
                 prompt_len=r.prompt_len, output_len=r.output_len,
                 slo_class=r.slo_class, prompt_tokens=r.prompt_tokens)
            for r in reqs]


def finish_key(reqs):
    return sorted((r.rid, round(r.finish_time, 12), r.tokens_generated)
                  for r in reqs)


@pytest.mark.parametrize("make_reqs", [poisson_requests, trace_requests],
                         ids=["poisson", "tagged-traces"])
def test_real_server_decisions_match_jax_simulator(make_reqs):
    system = EcoServeSystem(JFitted(**MODEL_KW), 2, JSLO(**SLO_KW),
                            instance_kwargs={"max_decode_batch": B,
                                             "max_prefill_batch": B})
    engine = SimulationEngine(system)
    log_sim = []
    engine.decision_log = log_sim
    system.decision_log = log_sim
    fin_sim = engine.run(make_reqs(JRequest), horizon=1e9)
    assert len(system.queue) == 0

    reqs = make_reqs(Request)
    with PaDGServer(tiny_cfg(), n_instances=2, slo=SLO(**SLO_KW),
                    econf=EngineConfig(max_batch=B, max_seq_len=S,
                                       eos_token=-1),
                    backend="real", device="cpu",
                    executor=FittedExecutor(**MODEL_KW)) as server:
        assert all(inst.engine.engine.device.type == "cpu"
                   for inst in server.instances)
        stats = server.serve(reqs, clock=VirtualClock(),
                             record_decisions=True)
    assert len(fin_sim) == len(reqs)
    assert stats.decisions == log_sim
    assert finish_key(stats.finished) == finish_key(fin_sim)
    for r in stats.finished:
        assert len(r.generated) == r.output_len
        assert all(0 <= t < VOCAB for t in r.generated)


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b",
                                  "recurrentgemma-2b"])
def test_real_server_tokens_match_jax_real_server(arch):
    def reqs(make):
        return poisson_requests(make, n=8, seed=3, mean_gap=0.01)

    jserver = JPaDGServer(tiny_cfg(jax_smoke_config, arch), n_instances=2,
                          slo=JSLO(**SLO_KW),
                          econf=JEngineConfig(max_batch=B, max_seq_len=S,
                                              eos_token=-1),
                          backend="real", executor=JFitted(**MODEL_KW))
    try:
        jparams = jserver.instances[0].engine.engine.params
        jstats = jserver.serve(reqs(JRequest), clock=JVirtualClock(),
                               record_decisions=True)
    finally:
        jserver.shutdown()

    cfg = tiny_cfg(arch=arch)
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    with PaDGServer(cfg, n_instances=2, slo=SLO(**SLO_KW),
                    econf=EngineConfig(max_batch=B, max_seq_len=S,
                                       eos_token=-1, device="cpu"),
                    executor=FittedExecutor(**MODEL_KW)) as server:
        for inst in server.instances:
            inst.engine.engine.params = bridged
        stats = server.serve(reqs(Request), clock=VirtualClock(),
                             record_decisions=True)
    assert stats.decisions == jstats.decisions
    want = {r.rid: r.generated for r in jstats.finished}
    got = {r.rid: r.generated for r in stats.finished}
    assert len(got) == 8 and got == want
