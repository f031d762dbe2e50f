"""The reference's ``long_500k`` shape in the port on the CPU: what the
card's 524288-token paths and their checks rest on.

``long_500k`` is a decode step, batch 1, over a 524288-position context
(``repro.launch.input_specs.INPUT_SHAPES``), for the configs whose blocks
all see a bounded context (``cfg.subquadratic``): rwkv6-3b,
recurrentgemma-2b, llama3-8b-sw and llama4-scout.

- Rotary frequencies bit-equal to the reference's for every config, and
  ``apply_rope`` at positions up to 524351 within 1e-6 of the reference's
  (torch's f32 pow was an ulp off at recurrentgemma-2b's frequency 111,
  2.8e-5 of the output at position 524287).
- One decode step of each eligible smoke config at ``cache_len`` 524287,
  from a ring and recurrent state drawn from a seed in the reference's
  ``init_cache`` layout and carried into the port's
  (``params.cache_from_jax``): logits and the updated cache against the
  reference's.
- The engine's prefill puts one row through the final norm and the head,
  with greedy tokens equal to the JAX engine's for prompts several
  windows long.
- A prefill's FFN over row chunks (``models.model.FFN_ROWS``) equal to the
  unchunked one; the MoE block stays whole.
- The chunked plain versions the card's 524288-step checks are held to
  (``rglru_scan_plain_chunked``, ``rwkv6_scan_plain`` carrying its state,
  ``flash_prefill_plain_chunked`` at the four archs' head groupings) equal
  to the unchunked ones.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
torch.exp(torch.zeros(64))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models as jm  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.launch.input_specs import INPUT_SHAPES, applicable  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import available_archs, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.kernels import flash_prefill as FP  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RW  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import (cache_from_jax, cache_to_jax,  # noqa: E402
                                params_from_jax)
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

LONG = INPUT_SHAPES["long_500k"].seq_len                  # 524288
POSITIONS = [0, 32767, 262143, LONG - 1, LONG + 63]
# f32 rotary at positions to 524351: with the frequencies' bits equal, the
# two sides part only where their f32 cos / sin do (a few ulps of 1)
ROPE_ATOL = 1e-6
ATOL = 1e-4            # f32 logits and caches; sums in another order
ELIGIBLE = ["rwkv6-3b", "recurrentgemma-2b", "llama3-8b-sw",
            "llama4-scout-17b-a16e"]
# smoke depth of the decode step: recurrentgemma-2b one whole (RG-LRU,
# RG-LRU, local attention) cycle and a tail layer, the others 2
DECODE_LAYERS = {"recurrentgemma-2b": 4}


def _rope_configs():
    out = []
    for arch in available_archs():
        for cfg in (get_config(arch), get_smoke_config(arch)):
            if cfg.rope != "none" and cfg.head_dim:
                out.append(pytest.param(cfg, id=cfg.name))
    return out


def _n_freq(cfg):
    return cfg.head_dim // 4 if cfg.rope == "half" else cfg.head_dim // 2


def test_long_500k_eligible_archs():
    """The four archs that run the shape are the reference's choice."""
    shape = INPUT_SHAPES["long_500k"]
    assert (shape.seq_len, shape.global_batch, shape.kind) == (
        524288, 1, "decode")
    got = [a for a in available_archs()
           if applicable(jax_get_config(a), shape) is None
           and not jax_get_config(a).is_encoder]
    assert sorted(got) == sorted(ELIGIBLE)


@pytest.mark.parametrize("cfg", _rope_configs())
def test_rope_freqs_bit_equal_to_reference(cfg):
    n = _n_freq(cfg)
    got = L._rope_freqs(cfg.rope_theta, n, "cpu").numpy()
    want = np.asarray(JL._rope_freqs(cfg.head_dim, cfg.rope_theta, n))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llama3-8b-sw",
                                  "llama4-scout-17b-a16e", "qwen3-4b",
                                  "chatglm3-6b", "qwen2-vl-2b"])
def test_apply_rope_at_500k_positions_matches_jax(arch):
    """recurrentgemma-2b's 256-wide heads (128 frequencies at theta 1e4)
    were 2.8e-5 apart at position 524287 before the frequencies took the
    reference's bits; theta 1e6 (qwen3-4b), half rope (chatglm3-6b) and
    M-RoPE (qwen2-vl-2b) beside the long_500k archs."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, len(POSITIONS), 3, cfg.head_dim)
                            ).astype("float32")
    pos = np.array([POSITIONS, POSITIONS[::-1]], dtype=np.int32)
    if cfg.rope == "mrope":
        pos = np.stack([pos, pos // 3, pos % 1000], -1).astype(np.int32)
    want = np.asarray(JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos)))
    got = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ROPE_ATOL, rtol=0)


def _jax_tree(cfg, seed):
    """The reference's weights as numpy, with non-zero norm scales so that
    every leaf matters."""
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed),
                                                   cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _drawn_cache(cfg, seed):
    """The reference's ``init_cache`` at batch 1 with every leaf drawn
    from ``seed``: full k/v rings, conv histories, h, token shifts and
    RWKV states (f32, at the scale a long context leaves them)."""
    tree = jax.tree.map(np.asarray, jm.init_cache(cfg, 1, LONG + 32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), tree)


def _configs(arch, layers=None):
    n = layers or DECODE_LAYERS.get(arch, 2)
    return (dataclasses.replace(jax_smoke_config(arch), num_layers=n),
            dataclasses.replace(get_smoke_config(arch), num_layers=n))


@pytest.mark.parametrize("arch", ELIGIBLE)
def test_cache_bridge_round_trips(arch):
    jcfg, cfg = _configs(arch)
    tree = _drawn_cache(jcfg, 3)
    cache = cache_from_jax(tree, cfg, device="cpu")
    like = tm.init_cache(cfg, 1, LONG + 32, device="cpu")
    assert {k: v.shape for k, v in cache.items()} == {
        k: v.shape for k, v in like.items()}
    back = cache_to_jax(cache, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ELIGIBLE)
def test_long_500k_decode_step_matches_jax(arch):
    """One decode step at cache_len 524287 (the long_500k step: position
    524287, ring row 524287 % window) from the same drawn cache on both
    sides: logits, and every leaf of the updated cache (the new ring row,
    h and the conv history, the shift and the RWKV state)."""
    jcfg, cfg = _configs(arch)
    tree = _jax_tree(jcfg, 11)
    jcache = _drawn_cache(jcfg, 12)
    cache = cache_from_jax(jcache, cfg, device="cpu")
    tok = np.random.default_rng(13).integers(2, cfg.vocab_size, (1, 1))
    # the reference op by op: compiled, XLA folds 1 / theta^e into
    # theta^-e, whose f32 pow on the CPU is an ulp off at 10 of the smoke
    # configs' 32 frequencies, which position 524287 turns into 7e-3 of a
    # rotated row (the fused program's rounding, not the function's)
    with jax.disable_jit():
        want, want_cache = jm.forward(
            jax.tree.map(jnp.asarray, tree), jcfg,
            {"tokens": jnp.asarray(tok)},
            cache=jax.tree.map(jnp.asarray, jcache),
            cache_len=jnp.full((1,), LONG - 1, jnp.int32))
    with torch.no_grad():
        got, got_cache = tm.forward(
            params_from_jax(tree, cfg, device="cpu"), cfg,
            {"tokens": torch.from_numpy(tok)}, cache=cache,
            cache_len=torch.full((1,), LONG - 1, dtype=torch.int32))
    assert got.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    want_cache = jax.tree.map(np.asarray, want_cache)
    back = cache_to_jax(got_cache, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(want_cache)
    changed = 0
    for a, b, before in zip(jax.tree.leaves(back),
                            jax.tree.leaves(want_cache),
                            jax.tree.leaves(jcache)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        changed += int(not np.array_equal(b, before))
    assert changed           # the step wrote its row or state
    if cfg.sliding_window:
        # the ring row of position 524287 in a full ring, and it alone
        row = (LONG - 1) % cfg.sliding_window
        drawn = cache_from_jax(jcache, cfg, device="cpu")["local_k"]
        moved = (got_cache["local_k"] != drawn).any(-1).any(-1)  # (L, 1, W)
        assert moved[:, 0].nonzero()[:, 1].unique().tolist() == [row]


class HeadRows:
    """Wraps ``layers.matmul`` while installed, recording the rows of each
    product with the model's head (the lm_head, or the tied embedding's
    transpose)."""

    def __init__(self, params, cfg):
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        self.ptr = head.untyped_storage().data_ptr()
        self.shape = (cfg.d_model, cfg.vocab_size)
        self.real, self.rows = L.matmul, []

    def __enter__(self):
        def recorded(x, w):
            if (tuple(w.shape) == self.shape
                    and w.untyped_storage().data_ptr() == self.ptr):
                self.rows.append(x.shape[:-1].numel())
            return self.real(x, w)
        L.matmul = recorded
        return self

    def __exit__(self, *exc):
        L.matmul = self.real


@pytest.mark.parametrize("arch", ELIGIBLE)
def test_engine_prefill_heads_one_row_tokens_match_jax(arch):
    """Prompts of 300 and 215 tokens (the smoke window is 64) and 12
    greedy tokens each: the head multiplies one row a prefill and one a
    slot a decode step, and the tokens equal the JAX engine's on its
    weights."""
    jcfg, cfg = _configs(arch)
    econf = dict(max_batch=2, max_seq_len=400, eos_token=-1)
    je = jeng.ServingEngine(jcfg, seed=5, econf=jeng.EngineConfig(**econf))
    te = ServingEngine(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, je.params), cfg, device="cpu"),
        econf=EngineConfig(**econf, device="cpu"))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab_size - 1, n).tolist()
               for n in (300, 215)]
    out = []
    with HeadRows(te.params, cfg) as heads:
        for make, eng in ((JRequest, je), (Request, te)):
            reqs = [make(rid=i, arrival_time=0.0, prompt_len=len(p),
                         output_len=12, prompt_tokens=p)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.prefill(r)
                if eng is te:
                    assert heads.rows[-1] == 1
            while eng.decode_step():
                pass
            out.append([r.generated for r in reqs])
    assert out[0] == out[1]
    assert [len(g) for g in out[1]] == [12, 12]
    # two prefills of one row, then 11 decode steps of max_batch rows
    assert heads.rows == [1, 1] + [2] * 11


@pytest.mark.parametrize("arch", ["llama3-8b-sw", "rwkv6-3b",
                                  "recurrentgemma-2b",
                                  "llama4-scout-17b-a16e"])
def test_ffn_row_chunks_equal_unchunked(arch, monkeypatch):
    """A prefill without grad puts its norm, dense FFN and residual through
    ``FFN_ROWS`` rows at a time; at 16 rows over 150 positions (the last
    chunk short) each row is what the whole-tensor pass gives.  The MoE
    block is not chunked (its capacity is over all the call's tokens),
    so llama4-scout's bits do not move at all."""
    _, cfg = _configs(arch)
    tree = _jax_tree(_configs(arch)[0], 21)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        2, cfg.vocab_size, (2, 150)))
    calls = []
    real = M._ffn_residual

    def counted(cfg_, kind, bp, x, mi):
        calls.append(x.shape[1])
        return real(cfg_, kind, bp, x, mi)
    monkeypatch.setattr(M, "_ffn_residual", counted)
    with torch.no_grad():
        whole, wc = tm.forward(params, cfg, {"tokens": toks},
                               return_cache=True)
        monkeypatch.setattr(M, "FFN_ROWS", 16)
        calls.clear()
        chunked, cc = tm.forward(params, cfg, {"tokens": toks},
                                 return_cache=True)
    if cfg.is_moe:
        assert calls == [150] * cfg.num_layers
        assert torch.equal(chunked, whole)
    else:
        assert calls == ([16] * 9 + [6]) * cfg.num_layers
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                                   atol=1e-5, rtol=1e-5)
    for key in wc:
        np.testing.assert_allclose(cc[key].numpy(), wc[key].numpy(),
                                   atol=1e-5, rtol=1e-5)
    # with grad (a training step) the FFN runs whole whatever its length
    calls.clear()
    tm.forward(params, cfg, {"tokens": toks[:, :40]}, return_cache=True)
    assert calls == [40] * cfg.num_layers


@pytest.mark.parametrize("T,chunk,h0,decay", [
    (1000, 64, False, "model"), (1024, 32, True, "slow"),
    (77, 512, True, "slow"), (4099, 100, False, "slow"),
    (4096, 512, False, "model"), (2048, 512, True, "strong")])
def test_rglru_plain_chunked_equals_step_loop(T, chunk, h0, decay):
    """The carry between chunks composes (decay product, local h) pairs as
    the kernel does: within a chunk the steps are the plain version's, so
    the two differ by the composed products' rounding, under
    ``chip_smoke.py``'s TOL["rglru"] (1e-5 + 1e-5 |plain|), at its decays:
    the model's range, -|N(0, 1)| / 10 (a chunk keeps a share of its
    carried h) and near -10."""
    rng = np.random.default_rng(T + chunk)
    shape = (2, T, 40)
    if decay == "model":
        gate = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
        log_a = -8.0 * np.log1p(np.e) * gate
    elif decay == "slow":
        log_a = -np.abs(rng.standard_normal(shape)) * 0.1
    else:
        log_a = rng.uniform(-10.5, -9.5, shape)
    b = (np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_a), 1e-12))
         * rng.standard_normal(shape))
    log_a, b = (torch.from_numpy(x.astype("float32")) for x in (log_a, b))
    h = (torch.from_numpy(rng.standard_normal((2, 40)).astype("float32"))
         if h0 else None)
    want = RG.rglru_scan_plain(log_a, b, h)
    got = RG.rglru_scan_plain_chunked(log_a, b, h, chunk)
    assert got.shape == want.shape
    assert torch.all((got - want).abs() <= 1e-5 + 1e-5 * want.abs())
    # one chunk holding everything is the step loop itself
    np.testing.assert_array_equal(
        RG.rglru_scan_plain_chunked(log_a, b, h, T).numpy(), want.numpy())


@pytest.mark.parametrize("cut", [128, 300, 777])
def test_rwkv6_plain_carries_its_state(cut):
    """``rwkv6_scan_plain`` over two pieces, the second from the first's
    final state, against one call: the state the card's 524288-step check
    holds the kernel's final state to."""
    rng = np.random.default_rng(cut)
    B, T, H, D = 1, 1000, 2, 64

    def draw(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)
                                 ).astype("float32"))
    r, k, v = (draw(B, T, H, D, scale=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(draw(B, T, H, D) - 5.0))
    u = draw(H, D, scale=0.1)
    o, s = RW.rwkv6_scan_plain(r, k, v, w, u)
    o1, s1 = RW.rwkv6_scan_plain(r[:, :cut], k[:, :cut], v[:, :cut],
                                 w[:, :cut], u)
    o2, s2 = RW.rwkv6_scan_plain(r[:, cut:], k[:, cut:], v[:, cut:],
                                 w[:, cut:], u, s1)
    rms = float(o.square().mean().sqrt())
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o.numpy(),
                               atol=1e-4 * rms, rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), atol=1e-4 * float(
        s.square().mean().sqrt()), rtol=1e-4)


# the long_500k archs' attention: llama4-scout's G 5 and llama3-8b-sw's G
# 4 under a window, recurrentgemma-2b's G 10 at D 256 under one, rows in
# chunks that cross the window's start
ATTN_CASES = [  # T, Hq, Hkv, D, window, rows
    (700, 10, 2, 64, 96, 64), (700, 8, 2, 64, 200, 128),
    (600, 10, 1, 256, 64, 50), (513, 5, 1, 128, 512, 512)]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"T{c[0]}-G{c[1] // c[2]}-D{c[3]}-w{c[4]}"
                              for c in ATTN_CASES])
def test_flash_plain_chunked_equals_unchunked_long_500k_groups(case):
    T, Hq, Hkv, D, window, rows = case
    rng = np.random.default_rng(T + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, T, h, D), "float32")) for h in (Hq, Hkv, Hkv))
    want, want_lse = FP.flash_prefill_plain(q, k, v, causal=True,
                                            window=window, return_lse=True)
    got, lse = FP.flash_prefill_plain_chunked(q, k, v, causal=True,
                                              window=window, rows=rows,
                                              return_lse=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6,
                               rtol=2e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=2e-6,
                               rtol=2e-6)
