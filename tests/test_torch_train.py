"""The port's training path on the CPU against the JAX package's, on
identical inputs made with numpy from a seed: the AdamW update, the loss
and every gradient leaf of ``make_loss_fn`` for the smoke config of every
assigned arch (the plain versions carry the gradients of all four kernels
on the CPU), 3-step loss curves of ``train_step`` against the reference's
``step_fn``, and checkpoints written by one package and read by the
other.  On the card the same step runs through the kernels
(``chip_smoke.py``: train parity and ``train``)."""
import os

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)
# the first torch.exp of a CPU process can come out less accurate on part
# of its tensor (ROADMAP Queue 3): one call before any comparison
torch.exp(torch.zeros(64))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED, get_smoke_config  # noqa: E402
from repro.models import init_params, make_loss_fn  # noqa: E402
from repro.training.checkpoint import (load_checkpoint as jax_load,  # noqa: E402
                                       save_checkpoint as jax_save)
from repro.training.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import get_smoke_config as torch_smoke  # noqa: E402
from repro_torch.params import (jax_treedef, params_from_jax,  # noqa: E402
                                params_to_jax, tree_leaves)
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa: E402
                                             save_checkpoint)
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_loop import (loss_and_grads,  # noqa: E402
                                             make_train_step, to_batch, train)

# The port's AdamW against the reference's on the same f32 inputs: the same
# expressions in the same order, apart from the global norm's sum over
# leaves, so the parameters agree to a few f32 steps of values near 1
ADAMW_ATOL = 1e-6
# loss of make_loss_fn: f32 sums of the same products in another order
# (differences seen: <= 1.5e-6 on losses near 6.3)
LOSS_RTOL = 1e-5
# each gradient leaf: |port - jax| <= 1e-4 * rms(jax leaf) + 1e-4 * |jax|;
# f32 sums in another order through two layers (seen: within 4e-6 of each
# leaf's largest gradient, under 0.04 of this limit)
GRAD_ATOL_RMS, GRAD_RTOL = 1e-4, 1e-4


def _smoke_batch(cfg, B=2, T=32, seed=0):
    """numpy inputs as ``tests/test_configs_smoke.py:_smoke_batch`` makes
    them: frames for audio, patches before the tokens for vision."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        return {"frames": rng.normal(size=(B, T, cfg.frontend_dim)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                    np.int32)}
    T_text = T - cfg.num_patches if cfg.modality == "vision" else T
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T_text)).astype(
        np.int32)}
    if cfg.modality == "vision":
        batch["patches"] = rng.normal(
            size=(B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, T_text)).astype(
        np.int32)
    return batch


def _bridged(arch, seed):
    """(JAX smoke config, its init_params as numpy, the port's config, the
    same weights as the port's CPU parameters)."""
    cfg = get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(seed), cfg))
    tcfg = torch_smoke(arch)
    return cfg, tree, tcfg, params_from_jax(tree, tcfg, "cpu")


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_the_reference(clip):
    """Three updates of the same parameters with the same gradients; the
    gradients' global norm is ~30 (clipped to 1) or ~0.03 (not)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (16, 24), "b": {"c": (24,), "d": (3, 8, 8)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = draw(1.0)
    grads = [draw(1.0 if clip == "active" else 1e-3) for _ in range(3)]
    jopt, topt = JaxAdamW(), AdamW()
    jp, js = params, jopt.init(params)
    tp = jax.tree.map(torch.from_numpy, params)
    tp = {"a": tp["a"].clone(), "b": {k: v.clone()
                                       for k, v in tp["b"].items()}}
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        for want, got in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ADAMW_ATOL)
        for want, got in zip(jax.tree.leaves(js.m) + jax.tree.leaves(js.v),
                             ts.m + ts.v):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ADAMW_ATOL)
    gnorm = np.sqrt(sum(float(np.sum(x ** 2))
                        for x in jax.tree.leaves(grads[0])))
    assert (gnorm > 1.0) == (clip == "active")
    assert ts.step == int(js.step) == 3


@pytest.mark.parametrize("arch", ASSIGNED)
def test_loss_and_grads_match_the_reference(arch):
    """``make_loss_fn``'s loss and every gradient leaf (mapped into the JAX
    layout through ``params_to_jax``) against ``jax.value_and_grad`` of the
    reference's, on the arch's smoke config (the counterpart of
    ``test_smoke_train_step``); unused leaves (an encoder's token
    embedding) have zero gradients on both sides."""
    cfg, tree, tcfg, params = _bridged(arch, 1)
    batch = _smoke_batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(make_loss_fn(cfg)))(
        tree, _jnp(batch))
    tloss, tgrads = loss_and_grads(tcfg, params,
                                   to_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    want_leaves = jax.tree.leaves(grads)
    got_leaves = tree_leaves(params_to_jax(tgrads, tcfg))
    assert len(got_leaves) == len(want_leaves)
    for i, (got, want) in enumerate(zip(got_leaves, want_leaves)):
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape, i
        rms = float(np.sqrt(np.mean(want ** 2)))
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_RMS * rms,
                                   err_msg=f"{arch} gradient leaf {i}")


@pytest.mark.parametrize("arch", ["llama3-8b", "hubert-xlarge", "rwkv6-3b",
                                  "recurrentgemma-2b"])
def test_train_step_loss_curve_matches_step_fn(arch):
    """Three steps of the port's ``train_step`` against the reference's
    ``step_fn`` (``jax.value_and_grad`` of its loss, then its AdamW, as
    ``repro.training.train_loop.train`` builds it) from the same weights,
    each step on the same batch of random labels, so the curve falls as
    the model fits it: the loss of each step."""
    cfg, tree, tcfg, params = _bridged(arch, 2)
    batches = [_smoke_batch(cfg)] * 3
    jopt = JaxAdamW(lr=1e-3)
    loss_fn = make_loss_fn(cfg)

    @jax.jit
    def step_fn(p, s, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        p, s = jopt.update(g, s, p)
        return p, s, loss

    jp, js, want = tree, jopt.init(tree), []
    for b in batches:
        jp, js, loss = step_fn(jp, js, _jnp(b))
        want.append(float(loss))
    step = make_train_step(tcfg, AdamW(lr=1e-3))
    ts, got = AdamW(lr=1e-3).init(params), []
    for b in batches:
        params, ts, loss = step(params, ts, to_batch(b, "cpu"))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_checkpoints_interoperate(tmp_path):
    """The port's npz is restored by the JAX package's ``load_checkpoint``
    into its ``init_params`` structure, and a JAX checkpoint by the
    port's: shapes, values and the step equal; the structure string the
    port writes is JAX's own.  recurrentgemma-2b at 4 layers has both a
    scanned cycle and a tail layer."""
    import dataclasses
    import json

    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              num_layers=4)
    tcfg = dataclasses.replace(torch_smoke("recurrentgemma-2b"),
                               num_layers=4)
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(3), cfg))
    params = params_from_jax(tree, tcfg, "cpu")
    save_checkpoint(str(tmp_path / "port"), params, tcfg, step=7)
    like = init_params(jax.random.key(4), cfg)
    restored, step = jax_load(str(tmp_path / "port.npz"), like)
    assert step == 7
    assert jax.tree.structure(restored) == jax.tree.structure(like)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        assert got.shape == want.shape and np.array_equal(got, want)
    meta = json.loads((tmp_path / "port.meta.json").read_text())
    assert meta["treedef"] == str(jax.tree.structure(like))
    assert meta["treedef"] == jax_treedef(params_to_jax(params, tcfg))

    jax_save(str(tmp_path / "jax"), tree, step=11)
    other = params_from_jax(jax.tree.map(np.asarray, like), tcfg, "cpu")
    back, step = load_checkpoint(str(tmp_path / "jax"), other, tcfg)
    assert step == 11
    for got, want in zip(tree_leaves(back), tree_leaves(params)):
        assert got.shape == want.shape and torch.equal(got, want)


def test_train_runs_on_the_cpu_only_when_asked(tmp_path):
    """``train`` on the CPU: the loss falls over 3 steps and the checkpoint
    it writes restores its parameters; the default device is the card,
    which raises here without one."""
    from repro_torch.data.pipeline import (ByteTokenizer, TokenDataset,
                                           synthetic_corpus)
    cfg = torch_smoke("llama3-8b")
    ds = TokenDataset.from_texts(synthetic_corpus(64),
                                 ByteTokenizer(cfg.vocab_size))
    logged = []
    params, losses = train(cfg, ds.batches(4, 64), steps=3, device="cpu",
                           checkpoint_path=str(tmp_path / "ck"),
                           log_fn=logged.append)
    assert len(losses) == 3 and losses[-1] < losses[0] and len(logged) == 2
    back, step = load_checkpoint(str(tmp_path / "ck"), params, cfg)
    assert step == 3 and all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(params)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(cfg, ds.batches(4, 64), steps=1)
