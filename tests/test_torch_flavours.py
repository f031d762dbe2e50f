"""The port's attention flavours against the JAX package on the CPU:
per-head q/k RMSNorm (qwen3-4b), rotary on the first half of the head
(chatglm3-6b) and M-RoPE with the vision-patch frontend (qwen2-vl-2b).

On the same weights (the JAX ``init_params`` pytree with every norm scale,
q/k norm and bias perturbed, bridged with ``params_from_jax``) and the same
inputs (made with numpy from a seed), in f32: prefill logits, prefill -> 8
decode steps and prefill with patches within 1e-4 of
``repro.models.forward``, on each arch's smoke config and on a narrow
variant at its real GQA group (4, 16 and 6); the new primitives against
the JAX functions; and the greedy tokens of the port's ``ServingEngine``,
``PaDGServer`` (with its decision log) and ``EcoServeAPI`` (with its text)
equal to the JAX package's."""
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
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.slo import SLO as JSLO  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving.api import EcoServeAPI as JEcoServeAPI  # noqa: E402
from repro.serving.padg_server import PaDGServer as JPaDGServer  # noqa: E402
from repro.serving.replay import VirtualClock as JVirtualClock  # noqa: E402
from repro.simulator.cost_model import FittedExecutor as JFitted  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import (available_archs, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.core.mitosis import _ACTOR_REGISTRY  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serving.api import EcoServeAPI  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.padg_server import PaDGServer  # noqa: E402
from repro_torch.serving.replay import VirtualClock  # noqa: E402
from repro_torch.simulator.cost_model import FittedExecutor  # noqa: E402

ATOL = 1e-4   # f32 logits; the two sides sum in another order
ARCHS = ["qwen3-4b", "chatglm3-6b", "qwen2-vl-2b"]
# each arch's real GQA group (32/8, 32/2, 12/2) on narrow heads
GROUP_KW = {"qwen3-4b": dict(num_heads=8, num_kv_heads=2),
            "chatglm3-6b": dict(num_heads=32, num_kv_heads=2),
            "qwen2-vl-2b": dict(num_heads=12, num_kv_heads=2)}


def _configs():
    out = {}
    for arch in ARCHS:
        smoke = get_smoke_config(arch)
        kw = GROUP_KW[arch]
        out[f"{arch}-smoke"] = smoke
        out[f"{arch}-g{kw['num_heads'] // kw['num_kv_heads']}"] = (
            dataclasses.replace(smoke, d_model=128, head_dim=32, **kw))
    return out


CONFIGS = _configs()


def _jax_params(cfg, seed):
    """JAX weights as numpy, with non-zero norm scales (the q/k norms
    included, so that their (1 + scale) factor is tested) and biases."""
    tree = jax.tree.map(np.asarray,
                        jm.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "norm" in name or "'b" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _both(cfg, seed):
    tree = _jax_params(cfg, seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _prefill_decode(cfg, seed, toks, n_dec, patches=None):
    """Prefill ``toks[:, :-n_dec]`` (after ``patches``), then decode the
    remaining tokens one at a time, on both packages: [(port logits, JAX
    logits)] for the prefill and each decode step."""
    jparams, params = _both(cfg, seed)
    B, T = toks.shape
    T0 = T - n_dec
    P = 0 if patches is None else patches.shape[1]
    jb = {"tokens": jnp.asarray(toks[:, :T0])}
    tb = {"tokens": torch.from_numpy(toks[:, :T0])}
    if patches is not None:
        jb["patches"] = jnp.asarray(patches)
        tb["patches"] = torch.from_numpy(patches)
    want, jcache = jm.forward(jparams, cfg, jb, return_cache=True)
    got, pc = tm.forward(params, cfg, tb, return_cache=True)
    assert got.shape == (B, P + T0, cfg.vocab_size)
    out = [(got, want)]
    S = P + T + 4
    jcache = jm.grow_cache(cfg, jcache, S)
    cache = tm.init_cache(cfg, B, S, device="cpu")
    for key in ("k", "v"):
        cache[key][:, :, :P + T0] = pc[key]
    jdecode = jax.jit(lambda p, t, c, n: jm.forward(p, cfg, {"tokens": t},
                                                    cache=c, cache_len=n))
    for i in range(n_dec):
        n = P + T0 + i
        tok = toks[:, T0 + i:T0 + i + 1]
        want, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                               jnp.full((B,), n, jnp.int32))
        got, cache = tm.forward(params, cfg, {"tokens": torch.from_numpy(
            tok)}, cache=cache, cache_len=torch.full((B,), n,
                                                     dtype=torch.int32))
        out.append((got, want))
    return out


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_match_jax(name):
    cfg = CONFIGS[name]
    jparams, params = _both(cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37))
    want, _ = jm.forward(jparams, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 37, cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_8_decode_steps_match_jax(name):
    cfg = CONFIGS[name]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 30))
    steps = _prefill_decode(cfg, 2, toks, 8)
    assert len(steps) == 9
    for got, want in steps:
        _close(got, want)


@pytest.mark.parametrize("name,n_patches", [("qwen2-vl-2b-smoke", 16),
                                            ("qwen2-vl-2b-g6", 10)])
def test_patches_prefill_then_decode_match_jax(name, n_patches):
    """Patches through the frontend before the tokens, at M-RoPE's patch
    grid positions (16 on a 4 x 4 grid, 10 on a 3-wide one), then 8
    decode steps at cache_len (the reference's decode position)."""
    cfg = CONFIGS[name]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 28))
    patches = rng.standard_normal((2, n_patches, cfg.frontend_dim)).astype(
        np.float32)
    steps = _prefill_decode(cfg, 5, toks, 8, patches)
    for got, want in steps:
        _close(got, want)
    # the patches matter: without them the text's logits differ
    plain = _prefill_decode(cfg, 5, toks, 0)[0][0]
    assert not np.allclose(plain[:, -1].numpy(),
                           steps[0][0][:, -1].numpy(), atol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaves_match_jax(arch):
    """The port's init_params draws the leaves of repro.models.init_params
    with their shapes: q_norm / k_norm zeros (qwen3-4b), the frontend
    projection at 0.02 (qwen2-vl-2b)."""
    cfg = get_smoke_config(arch)
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    ref = params_from_jax(_jax_params(cfg, 0), cfg, device="cpu")

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{path}/{i}").items()}
        return {path: tuple(tree.shape)}
    assert shapes(p) == shapes(ref)
    core = p["layers"][0]["core"]
    assert ("q_norm" in core) == cfg.qk_norm == ("k_norm" in core)
    if cfg.qk_norm:
        assert core["q_norm"].shape == (cfg.head_dim,)
        assert float(core["q_norm"].abs().sum()) == 0.0
    assert ("frontend" in p) == bool(cfg.frontend_dim)
    if cfg.frontend_dim:
        assert p["frontend"].shape == (cfg.frontend_dim, cfg.d_model)
        assert abs(float(p["frontend"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("arch", available_archs())
def test_check_supported(arch):
    """All 14 configs are ported, the audio encoder (hubert-xlarge) too;
    an unknown block kind still raises."""
    import dataclasses
    cfg = get_config(arch)
    L.check_supported(cfg)
    with pytest.raises(NotImplementedError):
        L.check_supported(dataclasses.replace(cfg, block_pattern=("conv",)))


# --------------------------------------------------------------------- #
# the primitives
# --------------------------------------------------------------------- #
def test_head_rms_norm_matches_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 7, 4, 64)) * 3).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = JL._head_rms_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    got = L.rms_norm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    # bf16 in, bf16 out, computed in f32: at most one bf16 step apart
    want = JL._head_rms_norm(jnp.asarray(scale, jnp.bfloat16),
                             jnp.asarray(x, jnp.bfloat16), 1e-6)
    got = L.rms_norm({"scale": torch.from_numpy(scale).bfloat16()},
                     torch.from_numpy(x).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("hd", [64, 128])
def test_half_rope_matches_jax(hd):
    """chatglm3's rope: n_freq = hd / 4 frequencies with the exponent over
    n_freq, on the first half of the head; the second half passes through
    bit for bit.  At positions past 0, where an exponent over hd / 2 would
    differ."""
    cfg = CONFIGS["chatglm3-6b-smoke"]
    assert cfg.rope == "half"
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(1, 4000, (2, 9))
    want = JL.apply_rope(cfg, jnp.asarray(x), jnp.asarray(pos))
    xt = torch.from_numpy(x)
    got = L.apply_rope(cfg, xt, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got[..., hd // 2:], xt[..., hd // 2:])
    # the exponent over hd / 2 (the full rope's) gives another rotation
    n = hd // 4
    wrong = 1.0 / cfg.rope_theta ** (torch.arange(n) / (hd // 2))
    ang = (torch.from_numpy(pos).float()[..., None] * wrong)[:, :, None]
    x1, x2 = xt[..., :n], xt[..., n:2 * n]
    rotated = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                         x2 * torch.cos(ang) + x1 * torch.sin(ang)], -1)
    assert not torch.allclose(rotated, got[..., :hd // 2], atol=1e-3)


def test_mrope_matches_jax():
    """M-RoPE: frequency slots 2:1:1 for (t, h, w), each section turned by
    its own column of positions; with equal columns it is the full rope."""
    cfg = CONFIGS["qwen2-vl-2b-smoke"]
    assert cfg.rope == "mrope"
    rng = np.random.default_rng(8)
    for hd in (32, 64, 128):
        x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
        pos = rng.integers(0, 4000, (2, 9, 3))
        want = JL.apply_rope(cfg, jnp.asarray(x), jnp.asarray(pos))
        got = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    t = torch.from_numpy(pos[..., 0])
    same = L.apply_rope(cfg, torch.from_numpy(x),
                        t[..., None].expand(2, 9, 3))
    full = L.apply_rope(dataclasses.replace(cfg, rope="full"),
                        torch.from_numpy(x), t)
    assert torch.equal(same, full)


@pytest.mark.parametrize("name,n_patches", [("qwen2-vl-2b-smoke", 0),
                                            ("qwen2-vl-2b-smoke", 16),
                                            ("qwen2-vl-2b-smoke", 10),
                                            ("qwen3-4b-smoke", 0)])
def test_default_positions_match_jax(name, n_patches):
    cfg = CONFIGS[name]
    want = JM._default_positions(cfg, 2, 25, n_patches)
    got = TM._default_positions(cfg, 2, 25, "cpu", n_patches)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------- #
# engine, server and API
# --------------------------------------------------------------------- #
B, S = 4, 160
VOCAB = 300
SLO_KW = dict(ttft=0.5, tpot=0.05)
MODEL_KW = dict(prefill_base=1e-3, prefill_per_token=1e-4, decode_base=5e-4,
                decode_per_seq=2e-4, decode_per_ctx_token=1e-6,
                kv_capacity=B * S)
# tiny widths at each arch's real GQA group
TINY_KW = {"qwen3-4b": dict(num_heads=8, num_kv_heads=2),
           "chatglm3-6b": dict(num_heads=16, num_kv_heads=1),
           "qwen2-vl-2b": dict(num_heads=6, num_kv_heads=1)}


def tiny_cfg(make, arch):
    return dataclasses.replace(make(arch), num_layers=2, d_model=128,
                               head_dim=32, d_ff=256, vocab_size=VOCAB,
                               **TINY_KW[arch])


def _bridged(jparams, arch):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           tiny_cfg(get_smoke_config, arch), device="cpu")


def poisson_requests(make, n=8, seed=3, mean_gap=0.01):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax(arch):
    """Two requests, the second joining mid-flight, on the JAX engine and
    on the port's engine with the JAX engine's weights."""
    je = jeng.ServingEngine(
        tiny_cfg(jax_smoke_config, arch), seed=3,
        econf=jeng.EngineConfig(max_batch=2, max_seq_len=64, eos_token=-1))
    te = ServingEngine(tiny_cfg(get_smoke_config, arch),
                       params=_bridged(je.params, arch),
                       econf=EngineConfig(max_batch=2, max_seq_len=64,
                                          eos_token=-1, device="cpu"))
    out = []
    for make, eng in ((JRequest, je), (Request, te)):
        r1 = make(rid=1, arrival_time=0.0, prompt_len=3, output_len=5,
                  prompt_tokens=[7, 3, 11])
        r2 = make(rid=2, arrival_time=0.0, prompt_len=5, output_len=5,
                  prompt_tokens=[21, 9, 2, 40, 8])
        eng.prefill(r1)
        eng.decode_step()
        eng.prefill(r2)
        for _ in range(6):
            eng.decode_step()
        out.append((r1.generated, r2.generated))
    assert out[0] == out[1]
    assert len(out[1][0]) == 5 and len(out[1][1]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_real_server_tokens_and_decisions_match_jax(arch):
    jserver = JPaDGServer(tiny_cfg(jax_smoke_config, arch), n_instances=2,
                          slo=JSLO(**SLO_KW),
                          econf=jeng.EngineConfig(max_batch=B, max_seq_len=S,
                                                  eos_token=-1),
                          backend="real", executor=JFitted(**MODEL_KW))
    try:
        jparams = jserver.instances[0].engine.engine.params
        jstats = jserver.serve(poisson_requests(JRequest),
                               clock=JVirtualClock(), record_decisions=True)
    finally:
        jserver.shutdown()

    bridged = _bridged(jparams, arch)
    with PaDGServer(tiny_cfg(get_smoke_config, arch), n_instances=2,
                    slo=SLO(**SLO_KW),
                    econf=EngineConfig(max_batch=B, max_seq_len=S,
                                       eos_token=-1, device="cpu"),
                    executor=FittedExecutor(**MODEL_KW)) as server:
        for inst in server.instances:
            inst.engine.engine.params = bridged
        stats = server.serve(poisson_requests(Request),
                             clock=VirtualClock(), record_decisions=True)
    assert stats.decisions == jstats.decisions
    want = {r.rid: r.generated for r in jstats.finished}
    got = {r.rid: r.generated for r in stats.finished}
    assert len(got) == 8 and got == want


PROMPTS = ["hello world", "padg serving", "rolling activation",
           "macro instances cooperate"]


@pytest.mark.parametrize("arch", ARCHS)
def test_api_text_and_tokens_match_jax(arch):
    """The port's EcoServeAPI on the JAX EcoServeAPI's weights gives the
    same tokens and text for each prompt."""
    econf = dict(max_batch=2, max_seq_len=64, eos_token=-1)
    japi = JEcoServeAPI(tiny_cfg(jax_smoke_config, arch), n_instances=2,
                        econf=jeng.EngineConfig(**econf))
    try:
        jparams = japi.server.instances[0].engine.engine.params
        want = japi.generate(PROMPTS, max_new_tokens=5)
    finally:
        japi.close()
    with EcoServeAPI(tiny_cfg(get_smoke_config, arch), n_instances=2,
                     econf=EngineConfig(**econf, device="cpu")) as api:
        bridged = _bridged(jparams, arch)
        for inst in api.server.instances:
            inst.engine.engine.params = bridged
        got = api.generate(PROMPTS, max_new_tokens=5)
    assert [r.prompt for r in got] == PROMPTS
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert all(len(r.tokens) == 5 for r in got)


def test_api_generate_streaming():
    """test_variants.py::test_serving_api_generate_streaming's contract on
    the port, and close() releases the server's registry entries."""
    cfg = tiny_cfg(get_smoke_config, "qwen3-4b")
    api = EcoServeAPI(cfg, n_instances=2,
                      econf=EngineConfig(max_batch=2, max_seq_len=64,
                                         eos_token=-1, device="cpu"))
    with api:
        assert all(_ACTOR_REGISTRY.get(inst.iid) is inst
                   for inst in api.server.instances)
        streamed = []
        res = api.generate(["hello world", "padg serving"],
                           max_new_tokens=4,
                           stream=lambda rid, tok: streamed.append((rid,
                                                                    tok)))
        assert len(res) == 2
        for r in res:
            assert len(r.tokens) == 4
            assert r.ttft_s >= 0
            assert isinstance(r.text, str)
        assert len(streamed) == 8
        assert [t for i, t in streamed if i == 1] == res[1].tokens
    assert all(_ACTOR_REGISTRY.get(inst.iid) is not inst
               for inst in api.server.instances)
