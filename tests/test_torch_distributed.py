"""The port's multi-device path on a 2x4 CPU mesh: 8 processes over
``gloo`` (``torch.distributed``), against the JAX package's sharded
programs on a 2x4 host mesh (Auto axes, 8 host devices) and against the
port's single-device path, on the same weights (the JAX ``init_params``
bridged through numpy).

Both worlds run once per module, each in a subprocess with a timeout of
its own: the JAX one with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
writes the weights, inputs and its results; the torch one spawns 8 ranks
that meet at a ``FileStore`` under the test's temporary directory (no
port, so xdist's workers cannot collide), and rank 0 writes its results.
A llama3-family model of 2 layers, d_model 256, 4 heads, 2 kv heads,
head_dim 64 (``tests/test_dryrun_small.py``'s): on the 4-way model axis
q's heads shard and the kv heads are replicated, so each model shard
attends its q head over the kv head it reads.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
TIMEOUT = 300
# the limits of tests/test_torch_train.py
ADAMW_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_ATOL_RMS, GRAD_RTOL = 1e-4, 1e-4
DECODE_STEPS = 6

CFG = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
           head_dim=64, d_ff=512, vocab_size=512)
# expert parallel (4 experts on the 4-way model axis, batch 4 over the
# data axis), replicated (6 experts), weight tensor parallel (batch 1,
# fsdp_params: each expert's contractions split over the data axis)
MOE_CASES = {"expert_parallel": dict(num_experts=4, batch=4, fsdp=False),
             "replicate": dict(num_experts=6, batch=4, fsdp=False),
             "weight_tensor_parallel": dict(num_experts=4, batch=1,
                                            fsdp=True)}
MOE_CFG = dict(d_model=128, d_ff=256, top_k=2, capacity_factor=1.25)

JAX_SCRIPT = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch.mesh import mesh_info
from repro.models import init_params, make_loss_fn
from repro.models.layers import init_moe, moe_block, MeshInfo

out_path, cfg_kw, moe_cases, moe_kw = sys.argv[1], *map(eval, sys.argv[2:5])
cfg = dataclasses.replace(get_smoke_config("llama3-8b"), **cfg_kw)
params = init_params(jax.random.key(0), cfg)
rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
jb = {k: jnp.asarray(v) for k, v in batch.items()}
loss_single = jax.jit(make_loss_fn(cfg))(params, jb)
mi = mesh_info(mesh, global_batch=8)
with mesh:
    loss_sharded = jax.jit(make_loss_fn(cfg, mi))(params, jb)

moe = {}
for name, case in moe_cases.items():
    mcfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                               num_experts=case["num_experts"], **moe_kw)
    mp = init_moe(jax.random.key(1), mcfg, jnp.float32)
    x = np.random.default_rng(2).normal(
        size=(case["batch"], 8, mcfg.d_model)).astype(np.float32)
    mmi = mesh_info(mesh, global_batch=case["batch"])
    if case["fsdp"]:
        mmi = dataclasses.replace(mmi, fsdp_params=True)
    with mesh:
        y = jax.jit(lambda p, x: moe_block(p, mcfg, x, mmi))(
            mp, jnp.asarray(x))
    y_local = moe_block(mp, mcfg, jnp.asarray(x), MeshInfo())
    moe[name] = {"params": jax.tree.map(np.asarray, mp), "x": x,
                 "y": np.asarray(y), "y_local": np.asarray(y_local)}
with open(out_path, "wb") as f:
    pickle.dump({"params": jax.tree.map(np.asarray, params), "batch": batch,
                 "loss_single": float(loss_single),
                 "loss_sharded": float(loss_sharded), "moe": moe}, f)
print("ok")
"""


# --------------------------------------------------------------------- #
# the torch world: 8 ranks, rank 0 writes what the tests check
# --------------------------------------------------------------------- #
def _world(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.input_specs import InputShape
    from repro_torch.launch.mesh import make_test_mesh, mesh_info
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          init_opt_state, place_batch,
                                          place_cache, place_params)
    from repro_torch.models import forward, init_cache, make_loss_fn
    from repro_torch.models.layers import MeshInfo, moe_block
    from repro_torch.models.spmd import P, full, place
    from repro_torch.params import params_from_jax, tree_leaves
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import loss_and_grads, to_batch

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD)
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    out = {}
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), **CFG)
    mesh = make_test_mesh(data=2, model=4)
    mi = mesh_info(mesh, global_batch=8)

    def fresh():
        return params_from_jax(ref["params"], cfg, "cpu")

    batch = to_batch(ref["batch"], "cpu")
    with torch.no_grad():
        out["loss_single"] = float(make_loss_fn(cfg)(fresh(), batch))
        out["loss_sharded"] = float(make_loss_fn(cfg, mi)(
            place_params(cfg, fresh(), mi),
            place_batch(cfg, batch, mi)).full_tensor())

    # one train step, sharded (ZeRO-1 moments) and on one device: the
    # gradients, then the AdamW update in place
    opt = AdamW()
    p1, p2 = fresh(), place_params(cfg, fresh(), mi)
    out["step_before"] = [t.detach().numpy().copy() for t in tree_leaves(p1)]
    l1, g1 = loss_and_grads(cfg, p1, batch)
    l2, g2 = loss_and_grads(cfg, p2, place_batch(cfg, batch, mi), mi)
    out["step_grads"] = ([g.numpy() for g in tree_leaves(g1)],
                         [full(g).numpy() for g in tree_leaves(g2)])
    opt.update(g1, opt.init(p1), p1)
    opt.update(g2, init_opt_state(cfg, p2, mi), p2)
    out["step_loss"] = (float(l1), float(l2.full_tensor()))
    out["step_params"] = ([t.detach().numpy() for t in tree_leaves(p1)],
                          [full(t).detach().numpy()
                           for t in tree_leaves(p2)])
    out["adamw"] = (opt.lr, opt.eps, opt.grad_clip)

    # ``train`` itself, 2 steps on the mesh and on one device, from the
    # bridged weights (its own init_params draws the port's)
    from repro_torch.training import train_loop
    train_loop.init_params = lambda c, g, dt, dev: fresh()
    two = [ref["batch"]] * 2
    out["train_losses"] = tuple(
        train_loop.train(cfg, iter(two), steps=2, device="cpu", mi=m,
                         log_fn=lambda s: None)[1]
        for m in (MeshInfo(), mi))

    # greedy prefill + decode through the step builders
    prompt = torch.as_tensor(ref["batch"]["tokens"][:, :12]).long()
    S = 12 + DECODE_STEPS + 1
    shape = InputShape("t", 12, 8, "prefill")
    prefill, _, _ = build_prefill_step(cfg, mi, shape, torch.float32)
    decode, _, _ = build_decode_step(cfg, mi, InputShape("t", S, 8,
                                                         "decode"),
                                     torch.float32)
    with torch.no_grad():
        params = fresh()
        logits, pc = forward(params, cfg, {"tokens": prompt},
                             return_cache=True)
        cache = init_cache(cfg, 8, S, torch.float32, "cpu")
        for k, v in pc.items():
            cache[k][:, :, :12] = v
        tok = logits[:, -1].argmax(-1, keepdim=True)
        single, s_logits = [tok[:, 0]], []
        for i in range(DECODE_STEPS):
            lens = torch.full((8,), 12 + i, dtype=torch.int32)
            logits, cache = forward(params, cfg, {"tokens": tok},
                                    cache=cache, cache_len=lens)
            s_logits.append(logits[:, 0])
            tok = logits[:, 0].argmax(-1, keepdim=True)
            single.append(tok[:, 0])

        pd = place_params(cfg, fresh(), mi)
        last, pcd = prefill(pd, place_batch(cfg, {"tokens": prompt}, mi))
        cache = init_cache(cfg, 8, S, torch.float32, "cpu")
        for k, v in pcd.items():
            cache[k][:, :, :12] = full(v)
        cache = place_cache(cfg, cache, mi)
        tok = full(last).argmax(-1, keepdim=True)
        sharded, d_logits = [tok[:, 0]], []
        for i in range(DECODE_STEPS):
            lens = torch.full((8,), 12 + i, dtype=torch.int32)
            logits, cache = decode(pd, cache, place(tok, P("data", None),
                                                    mesh),
                                   place(lens, P("data"), mesh))
            logits = full(logits)
            d_logits.append(logits)
            tok = logits.argmax(-1, keepdim=True)
            sharded.append(tok[:, 0])
    out["tokens"] = (torch.stack(single).numpy(),
                     torch.stack(sharded).numpy())
    out["decode_logits"] = (torch.stack(s_logits).numpy(),
                            torch.stack(d_logits).numpy())

    # moe_block's three branches
    from repro_torch.params import to_tensor
    out["moe"] = {}
    for name, case in MOE_CASES.items():
        mcfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                                   num_experts=case["num_experts"],
                                   **MOE_CFG)
        r = ref["moe"][name]
        mmi = mesh_info(mesh, global_batch=case["batch"])
        if case["fsdp"]:
            mmi = dataclasses.replace(mmi, fsdp_params=True)
        mp = {k: place(to_tensor(v, "cpu"), P(), mesh)
              for k, v in r["params"].items()}
        x = place(torch.from_numpy(r["x"]), P(mmi.batch_axes or None,
                                              None, None), mesh)
        with torch.no_grad():
            y = full(moe_block(mp, mcfg, x, mmi))
            y1 = moe_block({k: to_tensor(v, "cpu")
                            for k, v in r["params"].items()}, mcfg,
                           torch.from_numpy(r["x"]), MeshInfo())
        out["moe"][name] = (y.numpy(), y1.numpy())

    # to_placements: a dim over ("pod", "data") splits pod-major
    mesh3 = make_test_mesh(data=2, model=2, pod=2)
    t = torch.arange(8 * 3).reshape(8, 3)
    d = place(t, P(("pod", "data"), None), mesh3)
    coord = mesh3.get_coordinate()
    row = (coord[0] * 2 + coord[1]) * 2
    local_ok = bool(torch.equal(d.to_local(), t[row:row + 2]))
    oks = [None] * WORLD
    dist.all_gather_object(oks, local_ok)
    out["pod_major"] = oks
    out["pod_major_full"] = bool(torch.equal(d.full_tensor(), t))
    if rank == 0:
        with open(os.path.join(tmp, "torch.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp: str) -> None:
    import torch.multiprocessing as mp
    mp.spawn(_world, args=(tmp,), nprocs=WORLD, join=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, os.path.join(tmp, "jax.pkl"),
         repr(CFG), repr(MOE_CASES), repr(MOE_CFG)],
        capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    env.pop("XLA_FLAGS")
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), tmp],
        capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    with open(os.path.join(tmp, "torch.pkl"), "rb") as f:
        got = pickle.load(f)
    return ref, got


def test_sharded_loss_matches_jax_and_single_device(worlds):
    ref, got = worlds
    np.testing.assert_allclose(got["loss_sharded"], ref["loss_sharded"],
                               rtol=2e-4)
    np.testing.assert_allclose(got["loss_sharded"], got["loss_single"],
                               rtol=2e-4)
    np.testing.assert_allclose(got["loss_single"], ref["loss_single"],
                               rtol=LOSS_RTOL)


def test_sharded_train_step_matches_single_device(worlds):
    """The loss and every gradient leaf at tests/test_torch_train.py's
    limits; each parameter after AdamW within ADAMW_ATOL plus how far one
    step from zero moments may move the two apart given their gradients
    (``chip_smoke.adamw_limit``: the step is lr * (u + wd * p), u =
    g / (|g| + eps) for the clipped g, |u1 - u2| <= 2 |g1 - g2| /
    (|g1| + |g2| + eps)): where a gradient cancels to near eps, the sum
    order over the data shards moves u by a share of 1."""
    _, got = worlds
    l1, l2 = got["step_loss"]
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    g1, g2 = got["step_grads"]
    assert len(g1) == len(g2)
    for a, b in zip(g1, g2):
        rms = float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_RMS * rms)
    lr, eps, clip = got["adamw"]

    def scale(gs):
        norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                           for g in gs))
        return min(1.0, clip / (norm + 1e-12))
    s1, s2 = scale(g1), scale(g2)
    single, sharded = got["step_params"]
    for p0, a, b, ga, gb in zip(got["step_before"], single, sharded, g1,
                                g2):
        x, y = ga.astype(np.float64) * s1, gb.astype(np.float64) * s2
        du = 2 * np.abs(x - y) / (np.abs(x) + np.abs(y) + eps)
        limit = ADAMW_ATOL + lr * (du + 1e-5) + np.abs(p0) * 2.0 ** -22
        assert np.all(np.abs(b - a) <= limit), float(
            np.max(np.abs(b - a) - limit))


def test_train_on_the_mesh_matches_one_device(worlds):
    _, got = worlds
    single, sharded = got["train_losses"]
    assert len(single) == len(sharded) == 2
    np.testing.assert_allclose(sharded, single, rtol=LOSS_RTOL)


def test_sharded_prefill_decode_greedy_tokens(worlds):
    _, got = worlds
    single, sharded = got["tokens"]
    np.testing.assert_array_equal(sharded, single)
    a, b = got["decode_logits"]
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("branch", list(MOE_CASES))
def test_moe_block_branches_match_jax(worlds, branch):
    ref, got = worlds
    y, y1 = got["moe"][branch]
    np.testing.assert_allclose(y, ref["moe"][branch]["y"], rtol=2e-4,
                               atol=2e-4)
    # and the port's one-device MoE against the reference's
    np.testing.assert_allclose(y1, ref["moe"][branch]["y_local"],
                               rtol=2e-4, atol=2e-4)


def test_to_placements_splits_pod_major(worlds):
    _, got = worlds
    assert got["pod_major"] == [True] * WORLD
    assert got["pod_major_full"]


def test_mesh_info_drops_batch_axes_that_do_not_divide():
    from repro_torch.launch.mesh import mesh_info
    from repro_torch.models.spmd import AbstractMesh
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert mesh_info(mesh, global_batch=8).batch_axes == ("pod", "data")
    assert mesh_info(mesh, global_batch=1).batch_axes == ()
    assert mesh_info(mesh).model_axis == "model"


if __name__ == "__main__":
    _spawn(sys.argv[1])
