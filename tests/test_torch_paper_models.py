"""The paper's own evaluation models (llama-30b, codellama2-34b,
qwen2-72b) in the port against the JAX package on the CPU.

Each at a tiny width that keeps what sets it apart: llama-30b's MHA (4
heads on 4); codellama2-34b's and qwen2-72b's GQA group of 8 (8 query
heads on 1 KV head, head_dim 64); their rope theta of 1e6; qwen2-72b's qkv
bias; a vocabulary of 300, no multiple of 64 (as codellama2-34b's 32016 is
none).  On the JAX ``init_params`` weights (norm scales and biases
perturbed) bridged with ``params_from_jax``: a prefill and 4 decode steps'
f32 logits within 1e-4 of ``repro.models.forward``, and a bf16 prefill's
within 0.03 relative L2 (qwen2-72b's biases added in bf16); the greedy
tokens of the
port's ``ServingEngine`` equal to ``repro.serving.engine.ServingEngine``'s;
and a two-instance ``PaDGServer(backend="real")`` under each Table-4
profile (``simulator/workload.WORKLOADS``: alpaca, sharegpt, longbench;
Poisson arrivals, lengths drawn as the profile draws them and clipped to
the tiny ``max_seq_len``) with the decision log and the tokens of the JAX
real server."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
# The first torch.exp of a CPU process can come out less accurate on part
# of its tensor (ROADMAP Queue 3): one call before any f32 comparison.
torch.exp(torch.zeros(64))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.slo import SLO as JSLO  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving.padg_server import PaDGServer as JPaDGServer  # noqa: E402
from repro.serving.replay import VirtualClock as JVirtualClock  # noqa: E402
from repro.simulator import workload as jworkload  # noqa: E402
from repro.simulator.cost_model import FittedExecutor as JFitted  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.padg_server import PaDGServer  # noqa: E402
from repro_torch.serving.replay import VirtualClock  # noqa: E402
from repro_torch.simulator import workload  # noqa: E402
from repro_torch.simulator.cost_model import FittedExecutor  # noqa: E402

ATOL = 1e-4   # f32 logits; the two sides sum in another order
VOCAB = 300
ARCHS = ["llama-30b", "codellama2-34b", "qwen2-72b"]
TINY_KW = {"llama-30b": dict(num_heads=4, num_kv_heads=4, head_dim=32),
           "codellama2-34b": dict(num_heads=8, num_kv_heads=1, head_dim=64),
           "qwen2-72b": dict(num_heads=8, num_kv_heads=1, head_dim=64)}
B, S = 4, 160
SLO_KW = dict(ttft=0.5, tpot=0.05)
MODEL_KW = dict(prefill_base=1e-3, prefill_per_token=1e-4, decode_base=5e-4,
                decode_per_seq=2e-4, decode_per_ctx_token=1e-6,
                kv_capacity=B * S)


def tiny_cfg(get, arch):
    return dataclasses.replace(get(arch), num_layers=2, d_model=128,
                               d_ff=256, vocab_size=VOCAB, **TINY_KW[arch])


def test_tiny_configs_keep_what_sets_each_apart():
    for arch in ARCHS:
        cfg, full = tiny_cfg(get_config, arch), get_config(arch)
        assert cfg.rope_theta == full.rope_theta
        assert cfg.qkv_bias == full.qkv_bias
        assert (cfg.num_heads == cfg.num_kv_heads) == (
            full.num_heads == full.num_kv_heads)
        if full.num_heads != full.num_kv_heads:
            assert cfg.num_heads // cfg.num_kv_heads == 8 == (
                full.num_heads // full.num_kv_heads)
        assert cfg.vocab_size % 64
    assert get_config("codellama2-34b").rope_theta == 1e6
    assert get_config("qwen2-72b").qkv_bias


def _jax_params(cfg, seed):
    """JAX weights as numpy, norm scales and biases (qwen2-72b's q, k and
    v biases) perturbed away from their zero init."""
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "'b" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits_match_jax(arch):
    cfg = tiny_cfg(get_config, arch)
    jcfg = tiny_cfg(jax_get_config, arch)
    tree = _jax_params(jcfg, 5)
    if cfg.qkv_bias:
        core = tree["layers_scan"]["pos0"]["core"]
        assert all(np.abs(core[b]).max() > 0 for b in ("bq", "bk", "bv"))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, VOCAB, (2, 41))
    n_dec, T0 = 4, 37
    want, jcache = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(
        toks[:, :T0])}, return_cache=True)
    got, pc = tm.forward(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :T0])}, return_cache=True)
    assert got.shape == (2, T0, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    jcache = jm.grow_cache(jcfg, jcache, T0 + n_dec + 4)
    cache = tm.init_cache(cfg, 2, T0 + n_dec + 4, device="cpu")
    for key in ("k", "v"):
        cache[key][:, :, :T0] = pc[key]
    for i in range(n_dec):
        tok = toks[:, T0 + i:T0 + i + 1]
        want, jcache = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(tok)},
                                  cache=jcache,
                                  cache_len=jnp.full((2,), T0 + i, jnp.int32))
        got, cache = tm.forward(params, cfg, {"tokens": torch.from_numpy(
            tok)}, cache=cache, cache_len=torch.full((2,), T0 + i,
                                                     dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


# bf16 weights on both sides (seeds 5-7, 2 x 37 tokens): each side rounds
# its products, bias sums and attention to bf16 at its own places, and
# the logits differed by 0.0084-0.0115 relative L2; dropping qwen2-72b's
# q/k/v biases on one side gives 0.47.  The limit is about 2.5 times the
# largest seen.
BF16_LOGITS_REL_L2 = 0.03


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_logits_match_jax(arch):
    """The JAX weights rounded to bf16 on both sides: every product and
    the qkv bias sums run in bf16 (jnp's promotion of two bf16 operands,
    ``layers.matmul``'s in the port), logits bf16 on both sides."""
    cfg, jcfg = tiny_cfg(get_config, arch), tiny_cfg(jax_get_config, arch)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        _jax_params(jcfg, 5))
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, VOCAB, (2, 37))
    want = jm.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                      {"tokens": jnp.asarray(toks)})[0]
    got = tm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0]
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want, np.float64)
    rel = np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want)
    assert rel <= BF16_LOGITS_REL_L2, f"{arch}: relative L2 {rel:.4f}"


def _bridged(jparams, arch):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           tiny_cfg(get_config, arch), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax(arch):
    """Two requests, the second joining mid-flight, on the JAX engine and
    on the port's engine with the JAX engine's weights."""
    je = jeng.ServingEngine(
        tiny_cfg(jax_get_config, arch), seed=3,
        econf=jeng.EngineConfig(max_batch=2, max_seq_len=64, eos_token=-1))
    te = ServingEngine(tiny_cfg(get_config, arch),
                       params=_bridged(je.params, arch),
                       econf=EngineConfig(max_batch=2, max_seq_len=64,
                                          eos_token=-1, device="cpu"))
    out = []
    for make, eng in ((JRequest, je), (Request, te)):
        r1 = make(rid=1, arrival_time=0.0, prompt_len=3, output_len=9,
                  prompt_tokens=[7, 3, 11])
        r2 = make(rid=2, arrival_time=0.0, prompt_len=21, output_len=9,
                  prompt_tokens=list(range(5, 299, 14)))
        eng.prefill(r1)
        eng.decode_step()
        eng.prefill(r2)
        for _ in range(10):
            eng.decode_step()
        out.append((r1.generated, r2.generated))
    assert out[0] == out[1]
    assert len(out[1][0]) == 9 and len(out[1][1]) == 9


def table4_requests(make, module, profile, n=8, seed=11, mean_gap=0.01):
    """``n`` requests of a Table-4 profile: Poisson arrivals, lengths drawn
    by the profile's own distributions, prompts clipped to S - 40 and
    outputs to 12 (the tiny server's context), tokens from the seed."""
    rng = np.random.default_rng(seed)
    prof = module.WORKLOADS[profile]
    gaps = rng.exponential(mean_gap, n)
    ins = np.minimum(prof.input_dist.sample(rng, n), S - 40)
    outs = np.minimum(prof.output_dist.sample(rng, n), 12)
    tok_rng = np.random.default_rng(seed + 1)
    return [make(rid=i, arrival_time=float(t), prompt_len=int(p),
                 output_len=int(o),
                 prompt_tokens=tok_rng.integers(2, VOCAB - 1, int(p)).tolist())
            for i, (t, p, o) in enumerate(zip(np.cumsum(gaps) - gaps[0], ins,
                                              outs))]


@pytest.mark.parametrize("profile", ["sharegpt", "longbench", "alpaca"])
@pytest.mark.parametrize("arch", ARCHS)
def test_real_server_table4_matches_jax_real_server(arch, profile):
    jreqs = table4_requests(JRequest, jworkload, profile)
    reqs = table4_requests(Request, workload, profile)
    assert [(r.arrival_time, r.prompt_len, r.output_len, r.prompt_tokens)
            for r in reqs] == [(r.arrival_time, r.prompt_len, r.output_len,
                                r.prompt_tokens) for r in jreqs]
    jserver = JPaDGServer(tiny_cfg(jax_get_config, arch), n_instances=2,
                          slo=JSLO(**SLO_KW),
                          econf=jeng.EngineConfig(max_batch=B, max_seq_len=S,
                                                  eos_token=-1),
                          backend="real", executor=JFitted(**MODEL_KW))
    try:
        jparams = jserver.instances[0].engine.engine.params
        jstats = jserver.serve(jreqs, clock=JVirtualClock(),
                               record_decisions=True)
    finally:
        jserver.shutdown()

    with PaDGServer(tiny_cfg(get_config, arch), n_instances=2,
                    slo=SLO(**SLO_KW),
                    econf=EngineConfig(max_batch=B, max_seq_len=S,
                                       eos_token=-1, device="cpu"),
                    executor=FittedExecutor(**MODEL_KW)) as server:
        bridged = _bridged(jparams, arch)
        for inst in server.instances:
            inst.engine.engine.params = bridged
        stats = server.serve(reqs, clock=VirtualClock(),
                             record_decisions=True)
    assert stats.decisions == jstats.decisions
    want = {r.rid: r.generated for r in jstats.finished}
    got = {r.rid: r.generated for r in stats.finished}
    assert len(got) == 8 and got == want
    assert all(len(r.generated) == r.output_len for r in stats.finished)
