"""The port's recurrentgemma-2b path (RG-LRU + local attention) against the
JAX package on the CPU.

The RG-LRU scan's plain version (what CPU tensors run, and what
``chip_smoke.py`` holds the CUDA kernel against on the card) against the
Pallas kernel in interpret mode, ``repro.kernels.ref.rglru_scan_ref`` and
``rglru_scan_jnp`` on the inputs of ``tests/test_kernels.py`` (made with
numpy from a seed); the RG-LRU block, sliding-window attention with a ring
that wraps, and a recurrentgemma-shaped model (one full cycle plus a
2-layer RG-LRU tail, G = 10) against ``repro.models`` on bridged weights,
in f32.  The CUDA kernel itself runs only on the card."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models as jm  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import LOCAL_ATTN, RGLRU  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels.ops import rglru_scan_op  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

# f32 throughout: the reference tests' 1e-4 for the scan
# (test_kernels.py), and test_torch_model's 1e-4 for blocks and logits;
# cached k/v (one d_model-long product each, then rope) at 1e-5
TOL = dict(rtol=1e-4, atol=1e-4)
ATOL = 1e-4

# recurrentgemma-shaped and small: one full (RG-LRU, RG-LRU, local) cycle
# plus a 2-layer RG-LRU tail like the full 26 layers, G = Hq/Hkv = 10 as
# the full config, and a window of 16 that prompts overrun
CFG = dataclasses.replace(
    get_smoke_config("recurrentgemma-2b"), num_layers=5, d_model=160,
    num_heads=10, num_kv_heads=1, head_dim=16, d_ff=256, sliding_window=16)


def _scan_inputs(B, T, d, seed=0, h0=False):
    """tests/test_kernels.py's rglru inputs, as numpy."""
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.standard_normal((B, T, d))).astype(np.float32) * 0.1
    b = rng.standard_normal((B, T, d)).astype(np.float32) * 0.3
    state = rng.standard_normal((B, d)).astype(np.float32) if h0 else None
    return log_a, b, state


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("B,T,d,bt,bd", [
    (2, 64, 128, 32, 64),
    (1, 100, 256, 64, 128),        # T not a multiple of the Pallas block
    (3, 32, 96, 32, 128),          # d not a multiple of the Pallas block
])
def test_rglru_scan_plain_matches_references(B, T, d, bt, bd, h0):
    log_a, b, s0 = _scan_inputs(B, T, d, seed=T + d, h0=h0)
    got = RG.rglru_scan(*_t(log_a, b, s0))
    assert got.shape == (B, T, d) and got.dtype == torch.float32
    pallas = jax_rglru(*_j(log_a, b, s0), block_t=bt, block_d=bd,
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    want = ref.rglru_scan_ref(*_j(log_a, b, s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    model = JL.rglru_scan_jnp(*_j(log_a, b, s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(model), **TOL)


def test_rglru_scan_initial_state_matters_and_strong_decay():
    """A carried h0 changes the output; at log_a near -10 (the model's
    strongest decay) every h is its own b to f32 precision."""
    log_a, b, s0 = _scan_inputs(2, 40, 64, seed=9, h0=True)
    with_h0 = RG.rglru_scan(*_t(log_a, b, s0))
    without = RG.rglru_scan(*_t(log_a, b))
    assert float((with_h0 - without).abs().max()) > 1e-2
    strong = np.full_like(log_a, -10.0)
    got = RG.rglru_scan(*_t(strong, b, s0))
    want = ref.rglru_scan_ref(*_j(strong, b, s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[:, 1:].numpy(), b[:, 1:], atol=1e-3)


def test_rglru_scan_cpu_takes_the_plain_version_and_counts_nothing():
    args = _t(*_scan_inputs(1, 30, 64, h0=True))
    n = RG.rglru_scan.launches
    got = rglru_scan_op(*args)
    assert torch.equal(got, RG.rglru_scan_plain(*args))
    assert RG.rglru_scan.launches == n
    empty = RG.rglru_scan(args[0][:, :0], args[1][:, :0])
    assert empty.shape == (1, 0, 64)


def test_rglru_scan_rejects_malformed_inputs():
    log_a, b, s0 = _t(*_scan_inputs(2, 8, 32, h0=True))
    with pytest.raises(ValueError):
        RG.rglru_scan(log_a, b[:, :4])
    with pytest.raises(ValueError):
        RG.rglru_scan(log_a[0], b[0])
    with pytest.raises(ValueError):
        RG.rglru_scan(log_a, b, s0[:1])


# --------------------------------------------------------------------------- #
# Blocks and model on bridged weights
# --------------------------------------------------------------------------- #
def _jax_tree(cfg, seed):
    """JAX weights as numpy, with non-zero norm scales so every leaf
    matters."""
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _layer(tree, pos):
    """JAX layer ``pos`` of the first cycle as numpy."""
    return jax.tree.map(lambda a: a[0], tree["layers_scan"][f"pos{pos}"])


def _jcore(block):
    return jax.tree.map(jnp.asarray, block["core"])


def test_rglru_block_prefill_matches_jax():
    tree = _jax_tree(CFG, 0)
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][0]
    x = np.random.default_rng(1).normal(size=(2, 37, CFG.d_model)) \
        .astype(np.float32)
    want, wcache = JL.rglru_block(_jcore(_layer(tree, 0)), CFG,
                                  jnp.asarray(x), None, JL.MeshInfo(), True)
    got, cache = L.rglru_block(tblock["core"], CFG, torch.from_numpy(x),
                               layer_cache=None, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(wcache["conv"]), atol=1e-6)
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(wcache["h"]),
                               **TOL)
    # a prompt shorter than the conv history keeps zeros ahead of it
    _, short = L.rglru_block(tblock["core"], CFG, torch.from_numpy(x[:, :2]),
                             layer_cache=None, return_cache=True)
    assert short["conv"].shape == (2, 3, CFG.d_model)
    assert not short["conv"][:, 0].any()


def test_rglru_block_decode_matches_jax():
    """Decode steps from a carried conv history and h; the port updates
    the cache in place, history shifted by one row per step."""
    tree = _jax_tree(CFG, 2)
    jcore = _jcore(_layer(tree, 1))
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][1]
    rng = np.random.default_rng(3)
    B, d = 3, CFG.d_model
    conv = rng.normal(size=(B, 3, d)).astype(np.float32)
    h = rng.normal(size=(B, d)).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
    lc = {"conv": torch.from_numpy(conv.copy()), "h": torch.from_numpy(h)}
    for _ in range(4):
        x = rng.normal(size=(B, 1, d)).astype(np.float32)
        want, jcache = JL.rglru_block(jcore, CFG, jnp.asarray(x), jcache,
                                      JL.MeshInfo(), False)
        got, cache = L.rglru_block(tblock["core"], CFG, torch.from_numpy(x),
                                   layer_cache=lc, return_cache=False)
        assert cache is lc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(lc["conv"].numpy(),
                                   np.asarray(jcache["conv"]), atol=1e-6)
        np.testing.assert_allclose(lc["h"].numpy(), np.asarray(jcache["h"]),
                                   **TOL)


def test_rglru_block_rejects_a_prefill_from_a_carried_state():
    tree = _jax_tree(CFG, 0)
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][0]
    cache = tm.init_cache(CFG, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        L.rglru_block(tblock["core"], CFG, torch.zeros(1, 4, CFG.d_model),
                      layer_cache={"conv": cache["conv"][0],
                                   "h": cache["h"][0]},
                      return_cache=True)


@pytest.mark.parametrize("T", [40, 16, 9], ids=["T>W", "T=W", "T<W"])
def test_local_attention_prefill_and_ring_decode_match_jax(T):
    """Sliding-window attention, W = 16: the prefill attends over the window
    and returns its k/v ring-ordered in W rows (rolled when T > W, padded
    when T < W); then 20 decode steps write ring index len % W and attend
    over min(len + 1, W) rows, wrapping the ring."""
    tree = _jax_tree(CFG, 4)
    jcore = _jcore(_layer(tree, 2))
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][2]
    W = CFG.sliding_window
    rng = np.random.default_rng(T)
    B = 2
    x = rng.normal(size=(B, T, CFG.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T), (B, 1))
    kw = dict(window=W, mi=JL.MeshInfo())
    want, jcache = JL.attention_block(
        jcore, CFG, jnp.asarray(x), jnp.asarray(pos), layer_cache=None,
        cache_len=None, return_cache=True, **kw)
    got, cache = L.attention_block(
        tblock["core"], CFG, torch.from_numpy(x), torch.from_numpy(pos),
        window=W, layer_cache=None, cache_len=None, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for key in ("k", "v"):
        assert cache[key].shape == (B, W, CFG.num_kv_heads, CFG.head_dim)
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    for step in range(20):
        xs = rng.normal(size=(B, 1, CFG.d_model)).astype(np.float32)
        cl = np.full((B,), T + step, np.int32)
        want, jcache = JL.attention_block(
            jcore, CFG, jnp.asarray(xs), jnp.asarray(cl[:, None]),
            layer_cache=jcache, cache_len=jnp.asarray(cl),
            return_cache=False, **kw)
        got, cache = L.attention_block(
            tblock["core"], CFG, torch.from_numpy(xs),
            torch.from_numpy(cl[:, None]), window=W, layer_cache=cache,
            cache_len=torch.from_numpy(cl), return_cache=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-5)


@pytest.mark.parametrize("T", [37, 12], ids=["T>W", "T<W"])
def test_recurrentgemma_logits_match_jax(T):
    tree = _jax_tree(CFG, 0)
    params = params_from_jax(tree, CFG, device="cpu")
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, T))
    want, _ = jm.forward(jax.tree.map(jnp.asarray, tree), CFG,
                         {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = tm.forward(params, CFG, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, T, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_recurrentgemma_prefill_then_decode_matches_jax():
    """Prefill T-1 = 23 tokens (past the window of 16), write each
    sequence's cache into a slotted cache, decode the last token: JAX's
    decode at 1e-4 and JAX's full forward at 2e-2
    (test_configs_smoke.py's contract)."""
    tree = _jax_tree(CFG, 6)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, CFG, device="cpu")
    B, T = 2, 24
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (B, T))

    full, _ = jm.forward(jparams, CFG, {"tokens": jnp.asarray(toks)})
    _, jcache = jm.forward(jparams, CFG, {"tokens": jnp.asarray(
        toks[:, :-1])}, return_cache=True)
    jcache = jm.grow_cache(CFG, jcache, T + 4)
    want, _ = jm.forward(jparams, CFG, {"tokens": jnp.asarray(toks[:, -1:])},
                         cache=jcache,
                         cache_len=jnp.full((B,), T - 1, jnp.int32))

    cache = tm.init_cache(CFG, B + 1, T + 4, device="cpu")
    for b in range(B):
        _, pc = tm.forward(params, CFG, {"tokens": torch.from_numpy(
            toks[b:b + 1, :-1])}, return_cache=True)
        tm.write_slot(cache, pc, b, T - 1)
    lens = torch.full((B + 1,), T - 1, dtype=torch.int32)
    last = torch.from_numpy(np.concatenate([toks[:, -1:], [[0]]]))
    got, cache2 = tm.forward(params, CFG, {"tokens": last}, cache=cache,
                             cache_len=lens)
    assert cache2 is cache                  # updated in place
    np.testing.assert_allclose(got[:B, 0].numpy(), np.asarray(want[:, 0]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:B, 0].numpy(), np.asarray(full[:, -1]),
                               atol=2e-2, rtol=2e-2)


def test_params_from_jax_carries_rglru_leaves_and_the_tail():
    """Layer i of the port is JAX's layers_scan/pos{i % 3}[i // 3] for the
    full cycle and layers_tail[i - 3] for the 2-layer RG-LRU tail."""
    tree = _jax_tree(CFG, 8)
    params = params_from_jax(tree, CFG, device="cpu")
    assert len(params["layers"]) == 5 and len(tree["layers_tail"]) == 2
    assert set(params["layers"][0]["core"]) == {
        "w_x", "w_gate", "w_out", "conv_w", "w_in_gate", "w_rec_gate",
        "lambda"}
    assert set(params["layers"][2]["core"]) == {"wq", "wk", "wv", "wo"}
    for i in range(5):
        src = (_layer(tree, i) if i < 3 else tree["layers_tail"][i - 3])
        names = (("core", "wk"), ("ffn", "w_up")) if i == 2 else (
            ("core", "conv_w"), ("core", "lambda"), ("core", "w_rec_gate"),
            ("ffn", "w_gate"))
        for part, name in names + (("norm1", "scale"),):
            np.testing.assert_array_equal(
                params["layers"][i][part][name].numpy(), src[part][name])


def test_init_params_rglru_shapes_and_distributions():
    """Same leaves and shapes as repro.models.init_params, with
    init_rglru's distributions."""
    cfg = dataclasses.replace(CFG, d_model=512, num_heads=8, head_dim=64)
    p = tm.init_params(cfg, torch.Generator().manual_seed(0),
                       torch.float32, "cpu")
    ref_p = params_from_jax(_jax_tree(cfg, 0), cfg, device="cpu")

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{path}/{i}").items()}
        return {path: tuple(tree.shape)}
    assert shapes(p) == shapes(ref_p)
    core = p["layers"][0]["core"]
    for name in ("w_x", "w_gate", "w_out", "w_in_gate", "w_rec_gate"):
        assert abs(float(core[name].std()) - 512 ** -0.5) < 2e-3
    assert abs(float(core["conv_w"].std()) - 0.1) < 1e-2
    assert torch.all(core["lambda"] == 1.0)
    assert abs(float(p["layers"][2]["core"]["wq"].std())
               - 512 ** -0.5) < 2e-3


def test_init_cache_recurrentgemma_layout():
    """Local k/v sized W whatever max_len is, conv history and h in the
    model dtype, as repro.models' _block_cache; no global k/v."""
    cache = tm.init_cache(CFG, 3, 40, dtype=torch.bfloat16, device="cpu")
    n_rg = tm.model.layer_kinds(CFG).count(RGLRU)
    n_local = tm.model.layer_kinds(CFG).count(LOCAL_ATTN)
    assert (n_rg, n_local) == (4, 1)
    assert set(cache) == {"local_k", "local_v", "conv", "h"}
    kv = (n_local, 3, CFG.sliding_window, CFG.num_kv_heads, CFG.head_dim)
    assert cache["local_k"].shape == cache["local_v"].shape == kv
    assert cache["conv"].shape == (n_rg, 3, 3, CFG.d_model)
    assert cache["h"].shape == (n_rg, 3, CFG.d_model)
    assert all(v.dtype == torch.bfloat16 for v in cache.values())
