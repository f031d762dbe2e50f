"""The port's RWKV-6 path against the JAX package on the CPU.

The WKV scan's plain version (what CPU tensors run, and what
``chip_smoke.py`` holds the CUDA kernel against on the card) against the
Pallas kernel in interpret mode, ``repro.kernels.ref.rwkv6_ref`` and
``rwkv6_chunked_jnp``, on the inputs of ``tests/test_kernels.py`` (made
with numpy from a seed); the time-mix block, the channel mix and the
whole rwkv6-3b smoke model against ``repro.models`` on bridged weights,
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
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RS  # noqa: E402
from repro_torch.kernels.ops import rwkv6_scan_op  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

# f32 throughout.  Against the step-by-step oracle, the reference tests'
# 1e-3 (test_kernels.py); against rwkv6_chunked_jnp, which the plain
# version follows op for op, their 1e-4; model logits as test_torch_model.
TOL_REF = dict(rtol=1e-3, atol=1e-3)
TOL_CHUNKED = dict(rtol=1e-4, atol=1e-4)
ATOL = 1e-4

CFG = get_smoke_config("rwkv6-3b")


def _inputs(B, T, H, D, seed=42, s0=False):
    """tests/test_kernels.py's rwkv6 inputs, as numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.6, 0.999, (B, T, H, D)).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32) * 0.1
    state = (rng.normal(size=(B, H, D, D)).astype(np.float32) if s0
             else None)
    return r, k, v, w, u, state


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,T,H,D,bt", [
    (1, 64, 2, 64, 16),
    (2, 96, 4, 32, 32),            # T not a multiple of the Pallas block
    (1, 80, 2, 32, 32),
    (1, 300, 2, 64, 128),          # several 128-step chunks, ragged
])
def test_rwkv6_scan_plain_matches_references(B, T, H, D, bt):
    r, k, v, w, u, _ = _inputs(B, T, H, D)
    o, state = RS.rwkv6_scan(*_t(r, k, v, w, u))
    assert o.shape == (B, T, H, D) and state.shape == (B, H, D, D)
    want_o, want_s = ref.rwkv6_ref(*_j(r, k, v, w, u))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL_REF)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), **TOL_REF)
    ch_o, ch_s = JL.rwkv6_chunked_jnp(*_j(r, k, v, w, u))
    np.testing.assert_allclose(o.numpy(), np.asarray(ch_o), **TOL_CHUNKED)
    np.testing.assert_allclose(state.numpy(), np.asarray(ch_s),
                               **TOL_CHUNKED)
    pallas = jax_rwkv6(*_j(r, k, v, w, u), block_t=bt, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), **TOL_REF)


@pytest.mark.parametrize("T", [50, 200])
def test_rwkv6_scan_plain_with_initial_state(T):
    r, k, v, w, u, s0 = _inputs(2, T, 3, 32, seed=3, s0=True)
    o, state = RS.rwkv6_scan(*_t(r, k, v, w, u, s0))
    want_o, want_s = ref.rwkv6_ref(*_j(r, k, v, w, u), s0=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL_REF)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), **TOL_REF)
    ch_o, ch_s = JL.rwkv6_chunked_jnp(*_j(r, k, v, w, u), s0=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(ch_o), **TOL_CHUNKED)
    np.testing.assert_allclose(state.numpy(), np.asarray(ch_s),
                               **TOL_CHUNKED)
    # the carried state matters: without it the outputs differ
    o0, _ = RS.rwkv6_scan(*_t(r, k, v, w, u))
    assert float((o - o0).abs().max()) > 1e-2


def test_rwkv6_scan_cpu_takes_the_plain_version_and_counts_nothing():
    args = _t(*_inputs(1, 40, 2, 64)[:5])
    n = RS.rwkv6_scan.launches
    got = rwkv6_scan_op(*args)
    want = RS.rwkv6_scan_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert RS.rwkv6_scan.launches == n
    o, state = RS.rwkv6_scan(*[a[:, :0] for a in args[:4]], args[4])
    assert o.shape == (1, 0, 2, 64) and not state.abs().any()


def test_rwkv6_scan_rejects_malformed_inputs():
    r, k, v, w, u, s0 = _t(*_inputs(1, 8, 2, 64, s0=True))
    with pytest.raises(ValueError):
        RS.rwkv6_scan(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError):
        RS.rwkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError):
        RS.rwkv6_scan(r, k, v, w, u, s0[..., :32])


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


def _layer0(tree):
    """JAX layer 0 (pos0, cycle 0) as numpy."""
    return jax.tree.map(lambda a: a[0], tree["layers_scan"]["pos0"])


def test_rwkv6_block_prefill_matches_jax():
    tree = _jax_tree(CFG, 0)
    jblock = _layer0(tree)
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][0]
    x = np.random.default_rng(1).normal(size=(2, 150, CFG.d_model)) \
        .astype(np.float32)
    want, wcache = JL.rwkv6_block(jax.tree.map(jnp.asarray, jblock["core"]),
                                  CFG, jnp.asarray(x), None, JL.MeshInfo(),
                                  True)
    got, cache = L.rwkv6_block(tblock["core"], CFG, torch.from_numpy(x),
                               layer_cache=None, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(cache["shift"].numpy(),
                                  np.asarray(wcache["shift"]))
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(wcache["state"]), **TOL_CHUNKED)


def test_rwkv6_block_decode_matches_jax():
    """One decode step from a carried shift and state; the port updates
    the cache in place."""
    tree = _jax_tree(CFG, 2)
    jblock = _layer0(tree)
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][0]
    rng = np.random.default_rng(3)
    B, H, D = 3, CFG.num_heads, CFG.head_dim
    x = rng.normal(size=(B, 1, CFG.d_model)).astype(np.float32)
    shift = rng.normal(size=(B, CFG.d_model)).astype(np.float32)
    state = rng.normal(size=(B, H, D, D)).astype(np.float32)
    want, wcache = JL.rwkv6_block(
        jax.tree.map(jnp.asarray, jblock["core"]), CFG, jnp.asarray(x),
        {"shift": jnp.asarray(shift), "state": jnp.asarray(state)},
        JL.MeshInfo(), False)
    lc = {"shift": torch.from_numpy(shift.copy()),
          "state": torch.from_numpy(state.copy())}
    got, cache = L.rwkv6_block(tblock["core"], CFG, torch.from_numpy(x),
                               layer_cache=lc, return_cache=False)
    assert cache is lc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(lc["shift"].numpy(),
                                  np.asarray(wcache["shift"]))
    np.testing.assert_allclose(lc["state"].numpy(),
                               np.asarray(wcache["state"]), atol=1e-5,
                               rtol=1e-5)


def test_rwkv6_block_rejects_a_prefill_from_a_carried_state():
    tree = _jax_tree(CFG, 0)
    tblock = params_from_jax(tree, CFG, device="cpu")["layers"][0]
    cache = tm.init_cache(CFG, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        L.rwkv6_block(tblock["core"], CFG, torch.zeros(1, 4, CFG.d_model),
                      layer_cache={"shift": cache["shift"][0],
                                   "state": cache["state"][0]},
                      return_cache=True)


def test_channel_mix_matches_jax():
    tree = _jax_tree(CFG, 4)
    jffn = _layer0(tree)["ffn"]
    tffn = params_from_jax(tree, CFG, device="cpu")["layers"][0]["ffn"]
    x = np.random.default_rng(5).normal(size=(2, 9, CFG.d_model)) \
        .astype(np.float32)
    want = JL.channel_mix(jax.tree.map(jnp.asarray, jffn), jnp.asarray(x),
                          JL.MeshInfo())
    got = L.channel_mix(tffn, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_rwkv6_logits_match_jax():
    tree = _jax_tree(CFG, 0)
    params = params_from_jax(tree, CFG, device="cpu")
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 150))
    want, _ = jm.forward(jax.tree.map(jnp.asarray, tree), CFG,
                         {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = tm.forward(params, CFG, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 150, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_rwkv6_prefill_then_decode_matches_jax():
    """Prefill T-1 tokens, write the cache into a slotted cache, decode
    the last token: JAX's decode at 1e-4 and JAX's full forward at 2e-2
    (test_configs_smoke.py's contract)."""
    tree = _jax_tree(CFG, 6)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, CFG, device="cpu")
    B, T = 2, 24
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (B, T))

    full, _ = jm.forward(jparams, CFG, {"tokens": jnp.asarray(toks)})
    _, jcache = jm.forward(jparams, CFG, {"tokens": jnp.asarray(
        toks[:, :-1])}, return_cache=True)
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


def test_params_from_jax_carries_rwkv6_leaves():
    """Layer i of the port is JAX's layers_scan/pos0[i], RWKV-6 leaves
    included."""
    cfg = dataclasses.replace(CFG, num_layers=3)
    tree = _jax_tree(cfg, 8)
    params = params_from_jax(tree, cfg, device="cpu")
    scan = tree["layers_scan"]["pos0"]
    assert set(params["layers"][0]["core"]) == {
        "w_r", "w_k", "w_v", "w_g", "w_o", "mu", "decay_base",
        "decay_lora_a", "decay_lora_b", "bonus_u", "ln_out_scale"}
    assert set(params["layers"][0]["ffn"]) == {"w_in", "w_out"}
    for i in range(3):
        for part, name in (("core", "mu"), ("core", "bonus_u"),
                           ("core", "decay_lora_b"), ("core",
                                                      "ln_out_scale"),
                           ("ffn", "w_in"), ("ffn", "w_out")):
            np.testing.assert_array_equal(
                params["layers"][i][part][name].numpy(),
                scan[part][name][i])


def test_init_params_rwkv6_shapes_and_distributions():
    """Same leaves and shapes as repro.models.init_params, with
    init_rwkv6 / init_channel_mix's distributions."""
    cfg = dataclasses.replace(CFG, d_model=512, num_heads=8, d_ff=1024)
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
    core, ffn = p["layers"][0]["core"], p["layers"][0]["ffn"]
    assert abs(float(core["w_r"].std()) - 512 ** -0.5) < 2e-3
    assert abs(float(core["decay_lora_b"].std()) - 64 ** -0.5) < 1e-2
    assert abs(float(core["bonus_u"].std()) - 0.1) < 1e-2
    assert 0.0 <= float(core["mu"].min()) and float(core["mu"].max()) < 1.0
    assert abs(float(core["mu"].mean()) - 0.5) < 0.05
    assert torch.all(core["decay_base"] == -6.0)
    assert float(core["ln_out_scale"].abs().sum()) == 0.0
    assert abs(float(ffn["w_out"].std()) - 1024 ** -0.5) < 2e-3


def test_init_cache_rwkv6_layout():
    """shift in the model dtype and state in f32, as repro.models'
    _block_cache; no k/v for an attention-free model."""
    cache = tm.init_cache(CFG, 3, 16, dtype=torch.bfloat16, device="cpu")
    H, D = CFG.num_heads, CFG.head_dim
    assert set(cache) == {"shift", "state"}
    assert cache["shift"].shape == (CFG.num_layers, 3, CFG.d_model)
    assert cache["shift"].dtype == torch.bfloat16
    assert cache["state"].shape == (CFG.num_layers, 3, H, D, D)
    assert cache["state"].dtype == torch.float32
