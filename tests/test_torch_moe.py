"""The port's mixture of experts (phi3.5-moe top-2, llama4-scout top-1)
against the JAX package on the CPU, in f32.

On the same weights (the JAX pytree bridged with ``params_from_jax``) and
the same inputs (made with numpy from a seed): ``_moe_local`` and
``moe_block`` at smoke widths with the real 16 experts, within 2e-5, with
the routing (experts, queue positions, ``keep``) exactly the reference's,
at the default capacity factor, with an expert that overflows, without
drops, and with exact ties; the models' prefill logits and prefill -> 8
decode steps within 1e-4 (llama4-scout also at its G 5 with a window that
the requests overrun); and the greedy tokens of the port's
``ServingEngine`` and ``PaDGServer`` (with its decision log) equal to the
JAX package's at ``max_batch`` 4, where a request that finishes early
leaves a slot whose stale token is routed beside the live ones.  On bf16
tokens and router, the router's logits are the reference's f32 product."""
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
from repro.serving import engine as jeng  # noqa: E402
from repro.serving.padg_server import PaDGServer as JPaDGServer  # noqa: E402
from repro.serving.replay import VirtualClock as JVirtualClock  # noqa: E402
from repro.simulator.cost_model import FittedExecutor as JFitted  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serving.engine import (H100_SXM, EngineConfig,  # noqa: E402
                                        MeasuredExecutor, ServingEngine)
from repro_torch.serving.padg_server import PaDGServer  # noqa: E402
from repro_torch.serving.replay import VirtualClock  # noqa: E402
from repro_torch.simulator.cost_model import (FittedExecutor,  # noqa: E402
                                              InstanceCostModel)

PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
ARCHS = [PHI, SCOUT]
MOE_ATOL = 2e-5     # one block's f32 output; the sides sum in another order
ATOL = 1e-4         # f32 logits, as the other port tests


def moe_cfg(arch, **kw):
    """The arch's smoke width (d 256, d_ff 512) with its real 16 experts
    and top-k."""
    full = get_config(arch)
    return dataclasses.replace(get_smoke_config(arch),
                               num_experts=full.num_experts,
                               top_k=full.top_k, **kw)


def _moe_params(cfg, seed):
    tree = jax.tree.map(np.array, JL.init_moe(jax.random.key(seed), cfg,
                                              jnp.float32))
    return tree, {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def jax_route(tree, cfg, x):
    """The routing lines of ``repro.models.layers._moe_local``, in jnp on
    the reference's own primitives: experts, pos, keep."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(T * k / E * cfg.capacity_factor))
    logits = (jnp.asarray(x) @ jnp.asarray(tree["router"])).astype(
        jnp.float32)
    _, experts = jax.lax.top_k(logits, k)
    flat = jax.nn.one_hot(experts, E, dtype=jnp.int32).reshape(T * k, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(T, k)
    return np.asarray(experts), np.asarray(pos), np.asarray(pos < cap)


def _check_moe_local(cfg, tree, params, x):
    want = JL._moe_local(jax.tree.map(jnp.asarray, tree), cfg,
                         jnp.asarray(x), 0, cfg.num_experts)
    got = L._moe_local(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MOE_ATOL, rtol=0)
    r = L.moe_route(params, cfg, torch.from_numpy(x))
    experts, pos, keep = jax_route(tree, cfg, x)
    np.testing.assert_array_equal(r["experts"].numpy(), experts)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    return r


# --------------------------------------------------------------------- #
# the block
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [40, 8, 1], ids=["prefill", "decode8", "T1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_matches_jax(arch, T):
    """At the default capacity factor 1.25: a prefill of 40 tokens drops
    some choices; a decode step of 8 has cap 1 (8 k / 16 * 1.25 < 2)."""
    cfg = moe_cfg(arch)
    assert cfg.capacity_factor == 1.25
    tree, params = _moe_params(cfg, 0)
    x = np.random.default_rng(T).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    r = _check_moe_local(cfg, tree, params, x)
    assert L.moe_capacity(cfg, T) == max(1, int(T * cfg.top_k / 16 * 1.25))
    if T == 8:
        assert L.moe_capacity(cfg, T) == 1
    # softmax over the k chosen logits, the largest first
    top = r["logits"].gather(1, r["experts"])
    assert torch.all(top[:, :-1] >= top[:, 1:])
    torch.testing.assert_close(r["weights"], torch.softmax(top, -1))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_overflow_drops_match_jax(arch):
    """A router biased towards expert 3: it takes cap of the 40 tokens'
    choices and drops the rest, which keep only their other choice (top-2)
    or nothing (top-1); row cap of the buffer sums every dropped token."""
    cfg = moe_cfg(arch)
    tree, params = _moe_params(cfg, 1)
    tree["router"][:, 3] += 0.5
    params["router"][:, 3] += 0.5
    x = np.random.default_rng(2).standard_normal(
        (40, cfg.d_model)).astype(np.float32)
    x += np.asarray(tree["router"][:, 3])[None] * 2.0
    r = _check_moe_local(cfg, tree, params, x)
    cap = L.moe_capacity(cfg, 40)
    on3 = r["experts"] == 3
    assert int(on3.sum()) > cap
    assert int((on3 & r["keep"]).sum()) == cap
    assert int((~r["keep"]).sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_without_drops_matches_jax(arch):
    """capacity_factor = num_experts (test_configs_smoke.py's no-drop
    setting): every choice is kept, and the output is the dense sum of
    each token's chosen experts times its weights."""
    cfg = moe_cfg(arch, capacity_factor=16.0)
    tree, params = _moe_params(cfg, 2)
    x = np.random.default_rng(3).standard_normal(
        (24, cfg.d_model)).astype(np.float32)
    r = _check_moe_local(cfg, tree, params, x)
    assert bool(r["keep"].all())
    xt = torch.from_numpy(x)
    dense = torch.zeros_like(xt)
    for t in range(24):
        for c in range(cfg.top_k):
            e = int(r["experts"][t, c])
            h = (torch.nn.functional.silu(xt[t] @ params["w_gate"][e])
                 * (xt[t] @ params["w_up"][e]))
            dense[t] += r["weights"][t, c] * (h @ params["w_down"][e])
    got = L._moe_local(params, cfg, xt)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=MOE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_ties_take_the_lower_expert_first(arch):
    """Small-integer x and router make every logit exact on both sides, and
    make ties real: router columns repeat, so several experts share a
    token's largest logit.  The reference's top_k puts the lower index
    first; so must the port, and the whole routing and output agree."""
    cfg = moe_cfg(arch)
    rng = np.random.default_rng(4)
    base = rng.integers(-1, 2, (cfg.d_model, 4)).astype(np.float32)
    router = base[:, rng.integers(0, 4, 16)]          # 16 columns, 4 kinds
    tree, params = _moe_params(cfg, 3)
    tree["router"] = router
    params["router"] = torch.from_numpy(router.copy())
    x = rng.integers(-2, 3, (40, cfg.d_model)).astype(np.float32)
    r = _check_moe_local(cfg, tree, params, x)
    logits = r["logits"]
    kth = logits.gather(1, r["experts"][:, -1:])
    # ties at the k-th choice: more experts share its logit than are taken
    assert int(((logits >= kth).sum(-1) > cfg.top_k).sum()) > 10
    # the lower index first among equal logits
    order = torch.sort(logits, dim=-1, descending=True,
                       stable=True).indices
    assert torch.equal(r["experts"], order[:, :cfg.top_k])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_router_logits_are_the_reference_f32_product(arch):
    """On bf16 tokens and router, the reference's ``(x @ router).astype(
    float32)`` compiles (under jit, as its model runs) into one f32 product
    of the upcast operands, so its logits are not rounded to bf16 first.
    The port's routing takes the same f32 logits (logits rounded to bf16
    tie or swap near-equal experts at bf16's 8 bits), and its experts are
    the reference's."""
    cfg = moe_cfg(arch)
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((64, cfg.d_model)), jnp.bfloat16)
    router = jnp.asarray(rng.standard_normal((cfg.d_model, 16))
                         * cfg.d_model ** -0.5, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda a, w: (a @ w).astype(jnp.float32))(
        x, router))
    _, experts = jax.lax.top_k(jnp.asarray(want), cfg.top_k)

    def port(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    r = L.moe_route({"router": port(router)}, cfg, port(x))
    assert r["logits"].dtype == torch.float32
    np.testing.assert_allclose(r["logits"].numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(r["experts"].numpy(), np.asarray(experts))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch):
    """(B, T, d) routed as B * T tokens together, cast back to x's dtype."""
    cfg = moe_cfg(arch)
    tree, params = _moe_params(cfg, 5)
    x = np.random.default_rng(6).standard_normal(
        (3, 11, cfg.d_model)).astype(np.float32)
    want = JL.moe_block(jax.tree.map(jnp.asarray, tree), cfg,
                        jnp.asarray(x), JL.MeshInfo())
    got = L.moe_block(params, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MOE_ATOL, rtol=0)
    # the capacity is the whole call's: not the sum of per-row calls
    rows = torch.cat([L.moe_block(params, cfg, torch.from_numpy(x[b:b + 1]))
                      for b in range(3)])
    assert not torch.allclose(rows, got, atol=1e-3)


# --------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------- #
def _model_configs():
    phi = get_smoke_config(PHI)
    scout = get_smoke_config(SCOUT)
    # llama4-scout's G 5 (40 / 8) on narrow heads, its 16 experts and top-1,
    # and a window of 16 that the 30-token requests overrun
    g5 = dataclasses.replace(scout, num_heads=10, num_kv_heads=2,
                             head_dim=16, d_model=160, d_ff=256,
                             num_experts=16, sliding_window=16)
    return {"phi3.5-moe-smoke": phi, "llama4-scout-smoke": scout,
            "llama4-scout-g5": g5}


CONFIGS = _model_configs()


def _jax_params(cfg, seed):
    """JAX weights as numpy, norm scales perturbed so that they matter."""
    tree = jax.tree.map(np.asarray,
                        jm.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_match_jax(name):
    cfg = CONFIGS[name]
    tree = _jax_params(cfg, 0)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37))
    want, _ = jm.forward(jax.tree.map(jnp.asarray, tree), cfg,
                         {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 37, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_8_decode_steps_match_jax(name):
    """Prefill 22 tokens of a batch of 2, then decode 8 more one at a time
    (the two rows routed together, cap 1): every step's logits."""
    cfg = CONFIGS[name]
    tree = _jax_params(cfg, 2)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    B, T, n_dec = 2, 30, 8
    T0 = T - n_dec
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))
    want, jcache = jm.forward(jparams, cfg, {"tokens": jnp.asarray(
        toks[:, :T0])}, return_cache=True)
    got, pc = tm.forward(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :T0])}, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    S = T + 4
    jcache = jm.grow_cache(cfg, jcache, S)
    cache = tm.init_cache(cfg, B, S, device="cpu")
    for key, val in pc.items():
        if key in TM.SEQ_KEYS:
            cache[key][:, :, :T0] = val
        else:
            cache[key].copy_(val)
    jdecode = jax.jit(lambda p, t, c, n: jm.forward(p, cfg, {"tokens": t},
                                                    cache=c, cache_len=n))
    for i in range(n_dec):
        n = T0 + i
        tok = toks[:, n:n + 1]
        want, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                               jnp.full((B,), n, jnp.int32))
        got, cache = tm.forward(params, cfg, {"tokens": torch.from_numpy(
            tok)}, cache=cache, cache_len=torch.full((B,), n,
                                                     dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_bridge_carry_the_moe_leaves(arch):
    """init_params draws the reference's MoE leaves with their shapes and
    scales; params_from_jax carries the stacked (n_full, E, d, f) leaves
    of layers_scan/pos0 (a one-block pattern) to layer c, leaf by leaf."""
    cfg = dataclasses.replace(moe_cfg(arch), num_layers=3)
    p = tm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    tree = _jax_params(cfg, 0)
    ref = params_from_jax(tree, cfg, device="cpu")

    def leaves(t, path=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in leaves(v, f"{path}/{k}").items()}
        if isinstance(t, list):
            return {k2: v2 for i, v in enumerate(t)
                    for k2, v2 in leaves(v, f"{path}/{i}").items()}
        return {path: t}
    assert {k: tuple(v.shape) for k, v in leaves(p).items()} == \
        {k: tuple(v.shape) for k, v in leaves(ref).items()}
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    ffn = p["layers"][0]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down"}
    assert ffn["router"].shape == (d, E)
    assert ffn["w_gate"].shape == ffn["w_up"].shape == (E, d, f)
    assert ffn["w_down"].shape == (E, f, d)
    for name, std in (("router", d ** -0.5), ("w_gate", d ** -0.5),
                      ("w_up", d ** -0.5), ("w_down", f ** -0.5)):
        assert abs(float(ffn[name].std()) / std - 1.0) < 0.05
    stacked = tree["layers_scan"]["pos0"]["ffn"]
    assert stacked["w_gate"].shape == (3, E, d, f)
    for c in range(3):
        for name in ffn:
            np.testing.assert_array_equal(
                ref["layers"][c]["ffn"][name].numpy(), stacked[name][c])


@pytest.mark.parametrize("arch", ARCHS)
def test_executor_seeded_from_the_full_moe_config(arch):
    """The engine's MeasuredExecutor probes the cost model of the
    published config (active parameters: top-k experts) without error and
    predicts positive, growing times."""
    ex = MeasuredExecutor(seed_model=InstanceCostModel(cfg=get_config(arch),
                                                       hw=H100_SXM))
    assert 0 < ex.prefill_time([128]) < ex.prefill_time([1024])
    assert 0 < ex.decode_time(1, [128]) < ex.decode_time(8, [1024] * 8)


def test_write_slot_into_an_8192_row_ring():
    """llama4-scout's local layers keep an 8192-row ring whatever
    max_seq_len is: a prefill of 30 tokens lands in rows [:30] of its slot
    with zeros after them, and decode attends over min(len + 1, 8192)."""
    # without drops, so that the 4 slots' decode step routes like the
    # one-sequence forward it is held against
    cfg = dataclasses.replace(CONFIGS["llama4-scout-g5"], sliding_window=8192,
                              capacity_factor=16.0)
    params = tm.init_params(cfg, torch.Generator().manual_seed(1),
                            torch.float32, "cpu")
    cache = tm.init_cache(cfg, 4, 64, device="cpu")
    assert cache["local_k"].shape == (2, 4, 8192, 2, 16)
    toks = torch.randint(0, cfg.vocab_size, (1, 30),
                         generator=torch.Generator().manual_seed(2))
    logits, pc = tm.forward(params, cfg, {"tokens": toks}, return_cache=True)
    cache["local_k"][:, 2] = 7.0             # a previous request's rows
    tm.write_slot(cache, pc, 2, 30)
    assert torch.equal(cache["local_k"][:, 2, :30], pc["local_k"][:, 0, :30])
    assert not cache["local_k"][:, 2, 30:].any()
    assert logits.shape == (1, 30, cfg.vocab_size)
    # slot 2's decode is the full forward's last position
    lens = torch.tensor([0, 0, 30, 0], dtype=torch.int32)
    step, _ = tm.forward(params, cfg, {"tokens": toks[:, :1].expand(4, 1)},
                         cache=cache, cache_len=lens)
    full, _ = tm.forward(params, cfg, {"tokens": torch.cat(
        [toks, toks[:, :1]], 1)})
    torch.testing.assert_close(step[2, 0], full[0, -1], atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# engine and server
# --------------------------------------------------------------------- #
B, S = 4, 160
VOCAB = 300
SLO_KW = dict(ttft=0.5, tpot=0.05)
MODEL_KW = dict(prefill_base=1e-3, prefill_per_token=1e-4, decode_base=5e-4,
                decode_per_seq=2e-4, decode_per_ctx_token=1e-6,
                kv_capacity=B * S)
# tiny widths at each arch's real GQA group, 16 experts and top-k;
# llama4-scout with a window of 16 that the requests overrun
TINY_KW = {PHI: dict(num_heads=8, num_kv_heads=2),
           SCOUT: dict(num_heads=10, num_kv_heads=2, sliding_window=16)}


def tiny_cfg(make, arch):
    return dataclasses.replace(make(arch), num_layers=2, d_model=128,
                               head_dim=32, d_ff=256, vocab_size=VOCAB,
                               num_experts=16, **TINY_KW[arch])


def _bridged(jparams, arch):
    return params_from_jax(jax.tree.map(np.asarray, jparams),
                           tiny_cfg(get_smoke_config, arch), device="cpu")


def _engine_run(make, eng):
    """r1 finishes after one decode step and frees slot 0, whose stale
    token (r1's last) is then decoded and routed with r2 and the two
    never-used slots for 3 steps before r3 takes the slot."""
    r1 = make(rid=1, arrival_time=0.0, prompt_len=3, output_len=2,
              prompt_tokens=[7, 3, 11])
    r2 = make(rid=2, arrival_time=0.0, prompt_len=5, output_len=9,
              prompt_tokens=[21, 9, 2, 40, 8])
    r3 = make(rid=3, arrival_time=0.0, prompt_len=4, output_len=4,
              prompt_tokens=[5, 17, 250, 33])
    eng.prefill(r1)
    eng.prefill(r2)
    eng.decode_step()
    assert eng.slot_req[0] is None            # r1 done, slot 0 free
    for _ in range(3):
        eng.decode_step()
        assert int(eng.tokens[0, 0]) == r1.generated[-1]
    eng.prefill(r3)
    for _ in range(4):
        eng.decode_step()
    return r1.generated, r2.generated, r3.generated


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax_with_a_freed_slot(arch):
    econf = dict(max_batch=B, max_seq_len=64, eos_token=-1)
    je = jeng.ServingEngine(tiny_cfg(jax_smoke_config, arch), seed=3,
                            econf=jeng.EngineConfig(**econf))
    want = _engine_run(JRequest, je)
    bridged = _bridged(je.params, arch)
    cfg = tiny_cfg(get_smoke_config, arch)
    te = ServingEngine(cfg, params=bridged,
                       econf=EngineConfig(**econf, device="cpu"))
    got = _engine_run(Request, te)
    assert got == want
    assert [len(g) for g in got] == [2, 9, 4]
    # only occupied slots take a new token: the never-used ones kept 0
    assert te.tokens[2:, 0].tolist() == [0, 0]

    # the free slot's token is routed with the live one's: with slot 0 free
    # and slot 1 live, slot 1's logits change with slot 0's token
    te = ServingEngine(cfg, params=bridged,
                       econf=EngineConfig(**econf, device="cpu"))
    ra, rb = (Request(rid=i, arrival_time=0.0, prompt_len=3, output_len=9,
                      prompt_tokens=[7 + i, 3, 11]) for i in range(2))
    te.prefill(ra)
    te.prefill(rb)
    te.release(ra)
    rows = []
    for stale in range(24):
        te.tokens[0, 0] = stale
        logits, _ = tm.forward(te.params, cfg, {"tokens": te.tokens},
                               cache=te.cache, cache_len=torch.from_numpy(
                                   te.lengths))
        rows.append(logits[1, 0])
    assert any(not torch.equal(rows[0], r) for r in rows[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_real_server_tokens_and_decisions_match_jax(arch):
    """8 Poisson requests of 1-11 output tokens on two instances of 4
    slots: requests finish early and free slots while others decode."""
    def requests(make):
        rng = np.random.default_rng(3)
        tok_rng = np.random.default_rng(4)
        reqs, t = [], 0.0
        for i in range(8):
            plen = int(rng.integers(3, 60))
            reqs.append(make(rid=i, arrival_time=t, prompt_len=plen,
                             output_len=int(rng.integers(1, 12)),
                             prompt_tokens=tok_rng.integers(
                                 2, VOCAB - 1, plen).tolist()))
            t += float(rng.exponential(0.01))
        return reqs

    jserver = JPaDGServer(tiny_cfg(jax_smoke_config, arch), n_instances=2,
                          slo=JSLO(**SLO_KW),
                          econf=jeng.EngineConfig(max_batch=B, max_seq_len=S,
                                                  eos_token=-1),
                          backend="real", executor=JFitted(**MODEL_KW))
    try:
        jparams = jserver.instances[0].engine.engine.params
        jstats = jserver.serve(requests(JRequest), clock=JVirtualClock(),
                               record_decisions=True)
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
        stats = server.serve(requests(Request), clock=VirtualClock(),
                             record_decisions=True)
    assert stats.decisions == jstats.decisions
    want = {r.rid: r.generated for r in jstats.finished}
    got = {r.rid: r.generated for r in stats.finished}
    assert len(got) == 8 and got == want
