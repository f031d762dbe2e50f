"""The port's ServingEngine against the JAX one on the CPU: with the same
(bridged) weights both engines emit exactly the same greedy tokens, for
llama3-8b, rwkv6-3b and recurrentgemma-2b, under the contracts of
``tests/test_serving_engine.py`` and when a slot is reused by a shorter
prompt (the port writes prefill K/V in place and leaves the previous
request's rows past T behind; it overwrites an RWKV-6 slot's shift and
state, and a Griffin slot's local k/v ring, conv history and h,
whole)."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serving.engine import (H100_SXM, EngineConfig,  # noqa: E402
                                        ServingEngine)


ARCHS = ["llama3-8b", "rwkv6-3b", "recurrentgemma-2b"]
# recurrentgemma-2b: one full (RG-LRU, RG-LRU, local) cycle, and a window
# that prompt + output overrun, so the local k/v ring wraps
ARCH_KW = {"recurrentgemma-2b": dict(num_layers=3, sliding_window=8)}
# cache keys whose slot row a prefill overwrites whole
WHOLE_SLOT_KEYS = {"rwkv6-3b": ("shift", "state"),
                   "recurrentgemma-2b": ("local_k", "local_v", "conv", "h")}


def tiny_cfg(make=get_smoke_config, arch="llama3-8b"):
    cfg = make(arch)
    kw = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
              head_dim=64, d_ff=256, vocab_size=300)
    return dataclasses.replace(cfg, **{**kw, **ARCH_KW.get(arch, {})})


def engines(seed, max_batch=2, max_seq_len=64, arch="llama3-8b"):
    """A JAX engine and a port engine on the JAX engine's weights."""
    je = jeng.ServingEngine(
        tiny_cfg(jax_smoke_config, arch), seed=seed,
        econf=jeng.EngineConfig(max_batch=max_batch,
                                max_seq_len=max_seq_len, eos_token=-1))
    cfg = tiny_cfg(arch=arch)
    params = params_from_jax(jax.tree.map(np.asarray, je.params), cfg,
                             device="cpu")
    te = ServingEngine(cfg, params=params,
                       econf=EngineConfig(max_batch=max_batch,
                                          max_seq_len=max_seq_len,
                                          eos_token=-1, device="cpu"))
    return je, te


def requests(rid, prompt, n_new):
    kw = dict(rid=rid, arrival_time=0.0, prompt_len=len(prompt),
              output_len=n_new, prompt_tokens=list(prompt))
    return JRequest(**kw), Request(**kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax(arch):
    """test_engine_matches_full_forward_greedy's protocol on both."""
    je, te = engines(seed=3, arch=arch)
    jr, tr = requests(0, [5, 9, 17, 4, 33], 6)
    for eng, req in ((je, jr), (te, tr)):
        eng.prefill(req)
        while len(req.generated) < 6:
            eng.decode_step()
    assert tr.generated == jr.generated
    assert len(tr.generated) == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_concurrent_requests_match_jax(arch):
    """test_engine_concurrent_requests_isolated's interleaving on both."""
    je, te = engines(seed=4, arch=arch)
    p1, p2 = [7, 3, 11], [21, 9, 2, 40, 8]
    out = []
    for side, eng in enumerate((je, te)):
        r1, r2 = requests(1, p1, 5)[side], requests(2, p2, 5)[side]
        eng.prefill(r1)
        eng.decode_step()          # r1 advances alone
        eng.prefill(r2)            # r2 joins mid-flight
        for _ in range(6):
            eng.decode_step()
        out.append((r1.generated, r2.generated))
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reuse_by_shorter_prompt(arch):
    """A slot freed by a long request and reused by a shorter prompt still
    gives the shorter prompt's solo-run tokens: decode attends over
    min(len + 1, S) positions, never the stale rows past T, and an RWKV-6
    or Griffin prompt inherits nothing of the previous occupant's shift and
    state, or local k/v, conv history and h."""
    long_p = list(range(10, 50))
    short_p = [7, 3, 11, 5]
    je, te = engines(seed=6, max_batch=1, arch=arch)
    _, solo = engines(seed=6, max_batch=1, arch=arch)
    _, ts = requests(9, short_p, 6)
    solo.prefill(ts)
    solo_cache = {key: val.clone() for key, val in solo.cache.items()}
    while solo.slot_req[0] is not None:
        solo.decode_step()

    out = []
    for side, eng in enumerate((je, te)):
        ra, rb = requests(1, long_p, 8)[side], requests(2, short_p, 6)[side]
        eng.prefill(ra)
        while eng.slot_req[0] is not None:
            eng.decode_step()
        assert eng.free_slots() == [0]
        eng.prefill(rb)
        if eng is te:
            # the slot's recurrent (and local k/v) cache is the short
            # prompt's alone
            for key in WHOLE_SLOT_KEYS.get(arch, ()):
                assert torch.equal(te.cache[key], solo_cache[key])
        while eng.slot_req[0] is not None:
            eng.decode_step()
        out.append((ra.generated, rb.generated))
    assert out[0] == out[1]
    assert out[1][1] == ts.generated
    if arch == "llama3-8b":
        # the stale rows of the long request are still there past T
        assert bool(te.cache["k"][:, 0, len(short_p) + 6:len(long_p)]
                    .abs().sum() > 0)


def test_engine_records_timings_and_frees_slots():
    je, te = engines(seed=5)
    _, req = requests(0, [5, 9, 17, 4], 3)
    te.prefill(req)
    assert te.free_slots() == [1]
    while len(req.generated) < 3:
        te.decode_step()
    assert te.free_slots() == [0, 1]
    assert te.executor.prefill_time([4]) > 0
    assert te.executor.decode_time(2, ctx_sum=10) > 0
    _, r2 = requests(1, [1, 2], 1)
    te.prefill(r2)
    te.release(r2)
    assert te.free_slots() == [0, 1]


def test_executor_seeded_from_h100_profile():
    assert (H100_SXM.flops, H100_SXM.hbm_bw, H100_SXM.hbm_bytes) == (
        989e12, 3.35e12, 80e9)
    _, te = engines(seed=0)
    assert te.econf.device == "cpu" and te.device.type == "cpu"


@pytest.mark.parametrize("kw", [{}, dict(fallback_prefill=1e-3,
                                         fallback_decode=1e-2)],
                         ids=["default", "custom"])
def test_measured_executor_legacy_fallbacks_match_jax(kw):
    """test_serving_engine.py::test_measured_executor_legacy_fallbacks on
    the port: without a model to probe, the flat fallbacks apply, and the
    predictions equal the JAX executor's after the same observations."""
    from repro_torch.serving.engine import MeasuredExecutor
    ex, jex = MeasuredExecutor(**kw), jeng.MeasuredExecutor(**kw)
    per_tok = kw.get("fallback_prefill", 2e-4)
    per_seq = kw.get("fallback_decode", 5e-2)
    assert ex.prefill_time([10]) == pytest.approx(10 * per_tok)
    assert ex.decode_time(3) == pytest.approx(3 * per_seq)
    for tokens, dt in ((12, 4e-3), (40, 2e-2)):
        ex.observe_prefill(tokens, dt)
        jex.observe_prefill(tokens, dt)
    for batch, ctx, dt in ((1, 10, 3e-2), (3, 200, 9e-2)):
        ex.observe_decode(dt, batch=batch, ctx_sum=ctx)
        jex.observe_decode(dt, batch=batch, ctx_sum=ctx)
    for lens in ([1], [10, 20], [257]):
        assert ex.prefill_time(lens) == jex.prefill_time(lens)
    for batch, ctx in ((1, 0), (4, 512)):
        assert (ex.decode_time(batch, ctx_sum=ctx)
                == jex.decode_time(batch, ctx_sum=ctx))


def test_engine_config_greedy():
    """EngineConfig takes the reference's ``greedy`` field (default True)."""
    assert EngineConfig(greedy=True).greedy is True
    assert EngineConfig().greedy == jeng.EngineConfig().greedy


def test_engine_rejects_non_greedy():
    """The engine has no sampler: ``greedy=False`` raises at construction
    (before any weight is made) instead of decoding greedily anyway."""
    with pytest.raises(NotImplementedError, match="greedy"):
        ServingEngine(tiny_cfg(), econf=EngineConfig(greedy=False,
                                                     device="cpu"))
