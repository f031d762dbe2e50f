"""The port's training path in bf16 on the CPU against the JAX package's
on identical inputs made with numpy from a seed: the loss and every
gradient leaf of ``make_loss_fn`` on bf16 parameters for the smoke config
of every assigned arch; hubert-xlarge and qwen2-vl-2b with f32 frames and
patches, which jnp's promotion carries through the whole model in f32
(the attention included); the bf16 AdamW update; and 3-step loss curves
of the port's ``train(dtype=torch.bfloat16)`` against the reference's
``train(dtype=jnp.bfloat16)`` from the same weights.  bf16 rounds at
other places in the two frameworks (XLA fuses and keeps some
intermediates in f32), so each gradient leaf is held by its relative L2
difference ||port - jax|| / ||jax||, not element by element.  On the
card the same step runs through the kernels (``chip_smoke.py``: train
parity and ``train``)."""
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

import repro.models.layers as jax_layers  # noqa: E402
from repro.configs import ASSIGNED, get_smoke_config  # noqa: E402
from repro.models import init_params, make_loss_fn  # noqa: E402
from repro.training.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.training.train_loop import train as jax_train  # noqa: E402
from repro_torch.configs import get_smoke_config as torch_smoke  # noqa: E402
from repro_torch.models import layers as torch_layers  # noqa: E402
from repro_torch.params import (params_from_jax, params_to_jax,  # noqa: E402
                                to_numpy, tree_leaves)
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_loop import (loss_and_grads,  # noqa: E402
                                             to_batch)
from test_torch_train import _smoke_batch  # noqa: E402

# bf16 inputs on both sides (seed 1, batch 2 x 32): the loss differed by
# at most 1.5e-4 of itself (recurrentgemma-2b) and the gradient leaves by
# at most 0.035 relative L2 (rwkv6-3b; medians 0.014-0.024 per arch).
# The limits are about three and two times those.
BF16_LOSS_RTOL = 5e-4
BF16_GRAD_REL_L2 = 0.07
# f32 frames or patches with bf16 weights: both sides compute in f32 and
# round each gradient to bf16 at the end, so they differ by f32 sums in
# another order and the bf16 roundings those flip (seen: loss 1.5e-7,
# leaves 1e-4 relative L2)
PROMOTED_LOSS_RTOL = 1e-5
PROMOTED_GRAD_REL_L2 = 1e-3
# the bf16 AdamW step: the same f32 expressions on the same bf16 inputs,
# apart from the global norm's sum over leaves, so a parameter may land
# one bf16 step (2^-8 of its value) away where the f32 result sits on a
# rounding boundary (seen: every parameter equal); m and v in f32 as in
# the f32 test
ADAMW_PARAM_RTOL = 2.0 ** -8
ADAMW_ATOL = 1e-6
# 3-step train loss curves in bf16 (AdamW lr 1e-3): step 0 is the parity
# above, and the bf16 parameters each update writes can then land a step
# apart (seen: 2.8e-4 relative, llama3-8b; 3e-6 for hubert-xlarge, whose
# f32 frames keep its compute in f32); the limit is about 3.5 times that
CURVE_RTOL = 1e-3


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else float(
        np.linalg.norm(got))


def _bf16_bridged(arch, seed):
    """(JAX smoke config, its bf16 init_params as numpy, the port's
    config, the same bf16 weights as the port's CPU parameters)."""
    cfg = get_smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        init_params(jax.random.key(seed), cfg, jnp.bfloat16))
    tcfg = torch_smoke(arch)
    return cfg, tree, tcfg, params_from_jax(tree, tcfg, "cpu")


def _both_batches(batch, float_dtype):
    """The numpy batch for the reference (``jnp.asarray``) and the port
    (``to_batch``), float arrays cast to ``float_dtype`` on both sides
    (None: left f32, as both trains leave them)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = to_batch(batch, "cpu")
    if float_dtype is not None:
        jb = {k: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
              for k, v in jb.items()}
        tb = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
              for k, v in tb.items()}
    return jb, tb


def _both_loss_and_grads(arch, float_dtype):
    """((loss, grads) of the reference, the same of the port, the port's
    config) on the arch's bf16 smoke weights."""
    cfg, tree, tcfg, params = _bf16_bridged(arch, 1)
    jb, tb = _both_batches(_smoke_batch(cfg), float_dtype)
    want = jax.jit(jax.value_and_grad(make_loss_fn(cfg)))(tree, jb)
    return want, loss_and_grads(tcfg, params, tb), tcfg


def _check_close(arch, want, got, tcfg, loss_rtol, grad_rel_l2):
    (loss, grads), (tloss, tgrads) = want, got
    np.testing.assert_allclose(float(tloss), float(loss), rtol=loss_rtol)
    # every gradient comes back in its parameter's dtype, as jax's do
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tgrads))
    want_leaves = jax.tree.leaves(grads)
    got_leaves = tree_leaves(params_to_jax(tgrads, tcfg))
    assert len(got_leaves) == len(want_leaves)
    for i, (got, want) in enumerate(zip(got_leaves, want_leaves)):
        assert got.shape == want.shape, i
        rel = _rel_l2(got, np.asarray(want, np.float32))
        assert rel <= grad_rel_l2, f"{arch} gradient leaf {i}: {rel:.4f}"


@pytest.mark.parametrize("arch", ASSIGNED)
def test_bf16_loss_and_grads_match_the_reference(arch):
    """``make_loss_fn``'s loss and every gradient leaf on bf16 weights
    and bf16 inputs against ``jax.value_and_grad`` of the reference's."""
    want, got, tcfg = _both_loss_and_grads(arch, torch.bfloat16)
    _check_close(arch, want, got, tcfg, BF16_LOSS_RTOL, BF16_GRAD_REL_L2)


@pytest.mark.parametrize("arch,key", [("hubert-xlarge", "frames"),
                                      ("qwen2-vl-2b", "patches")])
def test_f32_frames_and_patches_promote_as_in_jax(arch, key, monkeypatch):
    """bf16 weights fed f32 frames (or patches), as both ``train``s feed
    a numpy batch: jnp promotes the frontend's product to f32, so the
    reference's attention and everything after it runs in f32.  The
    port's must too: the dtype of q that reaches attention on each side,
    then the loss and gradients at the f32 limits."""
    seen = {"jax": set(), "port": set()}
    jax_attn = jax_layers.blockwise_attention
    port_attn = torch_layers.flash_prefill_op

    def jax_spy(q, k, v, **kw):
        seen["jax"].add(str(q.dtype))
        return jax_attn(q, k, v, **kw)

    def port_spy(q, k, v, **kw):
        seen["port"].add(str(q.dtype).split(".")[-1])
        return port_attn(q, k, v, **kw)

    monkeypatch.setattr(jax_layers, "blockwise_attention", jax_spy)
    monkeypatch.setattr(torch_layers, "flash_prefill_op", port_spy)
    cfg = get_smoke_config(arch)
    assert _smoke_batch(cfg)[key].dtype == np.float32
    want, got, tcfg = _both_loss_and_grads(arch, None)
    assert seen["jax"] == {"float32"}
    assert seen["port"] == seen["jax"]
    _check_close(arch, want, got, tcfg, PROMOTED_LOSS_RTOL,
                 PROMOTED_GRAD_REL_L2)


def test_bf16_adamw_matches_the_reference():
    """Three updates of bf16 parameters with bf16 gradients: f32 moments,
    the result written back in bf16 on both sides."""
    rng = np.random.default_rng(7)
    shapes = {"a": (16, 24), "b": {"c": (24,), "d": (3, 8, 8)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: jnp.asarray(rng.normal(size=s) * scale, jnp.bfloat16),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    def port(tree):
        return {"a": _tensor(tree["a"]),
                "b": {k: _tensor(v) for k, v in tree["b"].items()}}

    params = draw(1.0)
    grads = [draw(1.0) for _ in range(3)]
    jopt, topt = JaxAdamW(), AdamW()
    jp, js = params, jopt.init(params)
    tp = port(params)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(port(g), ts, tp)
        for want, got in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert got.dtype == torch.bfloat16
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(to_numpy(got), want, atol=0,
                                       rtol=ADAMW_PARAM_RTOL)
        for want, got in zip(jax.tree.leaves(js.m) + jax.tree.leaves(js.v),
                             ts.m + ts.v):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ADAMW_ATOL)


def _tensor(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# (The MoE archs' curves are held in f32, in test_torch_train.py.  In bf16
# the two frameworks' activations differ by bf16 roundings, which move a
# router logit by up to ~1e-2 on these configs: at this seed
# llama4-scout's first layer sends a token near a tie to another expert in
# each framework at step 0, and both MoE archs' curves part by more than
# CURVE_RTOL from step 1.)
@pytest.mark.parametrize("arch", ["llama3-8b", "hubert-xlarge",
                                  "recurrentgemma-2b", "qwen3-4b",
                                  "chatglm3-6b", "qwen2-vl-2b"])
def test_bf16_train_curve_matches_the_reference(arch, monkeypatch):
    """``train(dtype=torch.bfloat16)`` against the reference's
    ``train(dtype=jnp.bfloat16)``, 3 steps of AdamW(lr=1e-3) on the same
    batch of random labels: the port's ``init_params`` is replaced by the
    reference's bf16 draw for the same seed (through ``params_from_jax``),
    so both start from one set of weights; batches go in as numpy, so
    hubert-xlarge's frames are f32 on both sides.  The loss of each step,
    falling as the model fits the batch."""
    seed = 3
    cfg = get_smoke_config(arch)
    tcfg = torch_smoke(arch)
    tree = jax.tree.map(np.asarray,
                        init_params(jax.random.key(seed), cfg, jnp.bfloat16))

    def bridged_init(c, generator, dtype, device):
        assert c == tcfg and dtype == torch.bfloat16
        return params_from_jax(tree, tcfg, device)

    monkeypatch.setattr(train_loop, "init_params", bridged_init)
    batch = _smoke_batch(cfg)
    _, want = jax_train(cfg, iter([batch] * 3), steps=3, dtype=jnp.bfloat16,
                        seed=seed, optimizer=JaxAdamW(lr=1e-3),
                        log_fn=lambda m: None)
    params, got = train_loop.train(tcfg, iter([batch] * 3), steps=3,
                                   dtype=torch.bfloat16, seed=seed,
                                   optimizer=AdamW(lr=1e-3),
                                   log_fn=lambda m: None, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    assert got[-1] < got[0] and want[-1] < want[0]
