"""The port's dense GQA decoder against ``repro.models`` on the CPU: the
same weights (the JAX ``init_params`` pytree bridged with
``params_from_jax``) and the same tokens give the same logits in f32, for
prefill and for prefill -> decode."""
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ATTN  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

ATOL = 1e-4   # f32 logits; the two sides sum in another order


def _configs():
    llama = get_smoke_config("llama3-8b")
    # qwen2-72b-shaped: qkv bias, GQA 4:1, rope theta 1e6
    qwen = dataclasses.replace(
        get_smoke_config("qwen2-72b"), num_heads=8, num_kv_heads=2,
        head_dim=32, d_model=128, d_ff=256)
    # G = 5 and a layers_tail: block_pattern of two ATTN over 3 layers
    tail = dataclasses.replace(
        llama, num_layers=3, block_pattern=(ATTN, ATTN), num_heads=10,
        num_kv_heads=2, head_dim=16, d_model=160)
    return {"llama3-8b-smoke": llama, "qwen2-72b-tiny": qwen,
            "gqa5-tail": tail}


CONFIGS = _configs()


def _jax_params(cfg, seed):
    """JAX weights as numpy, with non-zero norm scales and biases so that
    every leaf matters."""
    tree = jax.tree.map(np.asarray,
                        jm.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "'b" in name:
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
                         {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = tm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 37, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_decode_matches_jax(name):
    """Prefill T-1 tokens, write the cache into a longer slotted cache,
    decode the last token: the logits match JAX's decode and JAX's full
    forward (the contract of test_configs_smoke.py)."""
    cfg = CONFIGS[name]
    tree = _jax_params(cfg, 2)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    B, T = 2, 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))

    full, _ = jm.forward(jparams, cfg, {"tokens": jnp.asarray(toks)})
    _, jcache = jm.forward(jparams, cfg, {"tokens": jnp.asarray(
        toks[:, :-1])}, return_cache=True)
    jcache = jm.grow_cache(cfg, jcache, T + 4)
    want, _ = jm.forward(jparams, cfg, {"tokens": jnp.asarray(toks[:, -1:])},
                         cache=jcache,
                         cache_len=jnp.full((B,), T - 1, jnp.int32))

    _, pc = tm.forward(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :-1])}, return_cache=True)
    cache = tm.init_cache(cfg, B, T + 4, device="cpu")
    cache["k"][:, :, :T - 1] = pc["k"]
    cache["v"][:, :, :T - 1] = pc["v"]
    got, cache2 = tm.forward(params, cfg,
                             {"tokens": torch.from_numpy(toks[:, -1:])},
                             cache=cache,
                             cache_len=torch.full((B,), T - 1,
                                                  dtype=torch.int32))
    assert cache2 is cache                  # updated in place
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(full[:, -1]),
                               atol=2e-2, rtol=2e-2)


def test_params_from_jax_layer_order():
    """Layer i of the port is JAX's layers_scan/pos{p}[c] with
    i = c * plen + p, then the layers_tail tuple."""
    cfg = CONFIGS["gqa5-tail"]
    tree = _jax_params(cfg, 4)
    params = params_from_jax(tree, cfg, device="cpu")
    assert len(params["layers"]) == 3
    scan = tree["layers_scan"]
    np.testing.assert_array_equal(params["layers"][0]["core"]["wq"].numpy(),
                                  scan["pos0"]["core"]["wq"][0])
    np.testing.assert_array_equal(params["layers"][1]["core"]["wq"].numpy(),
                                  scan["pos1"]["core"]["wq"][0])
    np.testing.assert_array_equal(params["layers"][2]["core"]["wq"].numpy(),
                                  tree["layers_tail"][0]["core"]["wq"])


def test_init_params_shapes_and_distributions():
    """Same leaves, shapes and distributions as repro.models.init_params:
    normal*0.02 embedding and head, d**-0.5 projections, zero norms."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), d_model=128,
                              d_ff=512, vocab_size=4096)
    gen = torch.Generator().manual_seed(0)
    p = tm.init_params(cfg, gen, torch.float32, "cpu")
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
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    assert abs(float(p["lm_head"].std()) - 0.02) < 1e-3
    blk = p["layers"][0]
    assert abs(float(blk["core"]["wq"].std()) - 128 ** -0.5) < 5e-3
    assert abs(float(blk["ffn"]["w_down"].std()) - 512 ** -0.5) < 5e-3
    assert float(blk["norm1"]["scale"].abs().sum()) == 0.0


def test_rope_and_norm_match_jax():
    from repro.models import layers as JL
    cfg = get_smoke_config("llama3-8b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7))
    want = JL.apply_rope(cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    scale = rng.standard_normal(64).astype(np.float32)
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = L.rms_norm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    y = rng.standard_normal((4, 9)).astype(np.float32) * 50
    np.testing.assert_allclose(
        L.soft_cap(torch.from_numpy(y), 30.0).numpy(),
        np.asarray(JL.soft_cap(jnp.asarray(y), 30.0)), atol=1e-5)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "hubert-xlarge",
                                  "llama4-scout-17b-a16e"])
def test_unported_flavours_raise(arch):
    """The flavours once unported now build and run a forward: the MoE
    configs (parity with the JAX package: tests/test_torch_moe.py) and the
    audio encoder, on frames (parity of its loss and gradients:
    tests/test_torch_train.py); a flavour the port lacks still raises.
    (RWKV6, RG-LRU and local attention: tests/test_torch_rwkv6.py,
    tests/test_torch_rglru.py and the two tests below; qk_norm, half and
    mrope rope and the vision frontend: tests/test_torch_flavours.py.)"""
    import dataclasses
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError):
        tm.init_params(dataclasses.replace(cfg, rope="alibi"),
                       torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = ({"frames": torch.randn(2, 9, cfg.frontend_dim, generator=gen)}
             if cfg.modality == "audio" else
             {"tokens": torch.randint(0, cfg.vocab_size, (2, 9),
                                      generator=gen)})
    logits, _ = tm.forward(params, cfg, batch)
    assert logits.shape == (2, 9, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_sliding_window_ring_buffer_decode_matches_jax():
    """llama3-8b-sw (every block LOCAL_ATTN): test_configs_smoke.py's
    test_long_context_ring_buffer_decode on both packages and the same
    weights: decode far beyond the window gives JAX's logits, finite, and
    the ring holds exactly JAX's trailing window."""
    cfg = get_smoke_config("llama3-8b-sw")
    tree = _jax_params(cfg, 4)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    B, W = 1, cfg.sliding_window
    jcache = jm.init_cache(cfg, B, max_len=4 * W)
    cache = tm.init_cache(cfg, B, 4 * W, device="cpu")
    assert cache["local_k"].shape == (cfg.num_layers, B, W,
                                      cfg.num_kv_heads, cfg.head_dim)
    for pos in range(0, 3 * W, W // 2):
        want, jcache = jm.forward(jparams, cfg,
                                  {"tokens": jnp.ones((B, 1), jnp.int32)},
                                  cache=jcache,
                                  cache_len=jnp.full((B,), pos, jnp.int32))
        got, cache = tm.forward(params, cfg,
                                {"tokens": torch.ones((B, 1),
                                                      dtype=torch.long)},
                                cache=cache,
                                cache_len=torch.full((B,), pos,
                                                     dtype=torch.int32))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    for key, jkey in (("local_k", "k"), ("local_v", "v")):
        np.testing.assert_allclose(
            cache[key].numpy(),
            np.asarray(jcache["scan"]["pos0"][jkey]), atol=ATOL, rtol=0)


def test_recurrentgemma_init_params():
    """recurrentgemma-2b's smoke config (RG-LRU and local attention) now
    initialises: one dict per layer, in the pattern's kinds."""
    cfg = get_smoke_config("recurrentgemma-2b")
    p = tm.init_params(cfg, torch.Generator().manual_seed(0),
                       torch.float32, "cpu")
    assert len(p["layers"]) == cfg.num_layers == 3
    assert "lambda" in p["layers"][0]["core"]
    assert "lambda" in p["layers"][1]["core"]
    assert "wq" in p["layers"][2]["core"]
    assert all(torch.isfinite(t).all() for blk in p["layers"]
               for part in blk.values() for t in part.values())
