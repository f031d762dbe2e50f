"""The port's sharding rules (``repro_torch.models.shardings``) against the
reference's (``repro.models.shardings``) at both production meshes, 16x16
and 2x16x16, for the 10 assigned configs at full size: parameter,
optimizer-state, cache and batch specs leaf by leaf (the reference on a
``jax.sharding.AbstractMesh``, the port on its own ``AbstractMesh``: no
devices, no process group), and the ``fsdp`` variant by the bytes each
device holds of every layer group.  Also the launch layer's tables:
``INPUT_SHAPES``, ``applicable`` and ``model_flops`` for the 11 configs
(the assigned ones and ``llama3-8b-sw``) and all four shapes, and the
shapes of ``batch_specs``.  ``to_placements``' pod-major order is checked
on a real 2x2x2 mesh in ``tests/test_torch_distributed.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED, get_config  # noqa: E402
from repro.launch import dryrun_lib as ref_dryrun  # noqa: E402
from repro.launch import input_specs as ref_inputs  # noqa: E402
from repro.launch.mesh import mesh_info as ref_mesh_info  # noqa: E402
from repro.launch.steps import abstract_params as ref_abstract  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import shardings as ref_sh  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.launch import dryrun_lib  # noqa: E402
from repro_torch.launch import input_specs  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION, mesh_info  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models import shardings as sh  # noqa: E402
from repro_torch.models.model import CACHE_KEYS, layer_kinds  # noqa: E402
from repro_torch.models.spmd import AbstractMesh, spec_axes  # noqa: E402

MESHES = {"pod16x16": False, "pod2x16x16": True}
ALL_ARCHS = ASSIGNED + ["llama3-8b-sw"]


def _norm(spec):
    """A spec as a plain tuple: 1-tuples of axes as the axis, no trailing
    Nones."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, tuple) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _meshes(multi_pod):
    shape, axes = PRODUCTION[multi_pod]
    return (jax.sharding.AbstractMesh(shape, axes),
            AbstractMesh(shape, axes))


def _infos(multi_pod, global_batch=None, **kw):
    jm, tm = _meshes(multi_pod)
    ri = ref_mesh_info(jm, global_batch=global_batch)
    ti = mesh_info(tm, global_batch=global_batch)
    return dataclasses.replace(ri, **kw), dataclasses.replace(ti, **kw)


def _ref_leaves(cfg, tree):
    """(port path, reference spec with its layer axis dropped) of every
    leaf of a reference parameter-shaped tree of specs."""
    plen = len(cfg.block_pattern)
    n_full = cfg.num_layers // plen
    out = {}

    def walk(node, path):
        if isinstance(node, jax.sharding.PartitionSpec):
            out[path] = node
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(tree, ())
    flat = {}
    for path, spec in out.items():
        if path[0] == "layers_scan":
            p = int(path[1][3:])
            for c in range(n_full):
                flat[("layers", str(c * plen + p)) + path[2:]] = \
                    tuple(spec)[1:]
        elif path[0] == "layers_tail":
            flat[("layers", str(n_full * plen + int(path[1])))
                 + path[2:]] = tuple(spec)
        else:
            flat[path] = tuple(spec)
    return flat


def _port_leaves(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, sh.PartitionSpec):
            out[path] = tuple(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def abstract():
    """Each assigned arch's (reference, port) shape-only parameters."""
    return {a: (ref_abstract(get_config(a), jnp.bfloat16),
                abstract_params(torch_config(a), torch.bfloat16))
            for a in ASSIGNED}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_opt_state_specs_equal_the_reference(abstract, arch,
                                                       mesh):
    cfg, tcfg = get_config(arch), torch_config(arch)
    ri, ti = _infos(MESHES[mesh], global_batch=256)
    rp, tp = abstract[arch]
    for ref_fn, fn in ((ref_sh.param_pspecs, sh.param_pspecs),
                       (ref_sh.opt_state_pspecs, sh.opt_state_pspecs)):
        want = _ref_leaves(cfg, ref_fn(cfg, rp, ri))
        got = _port_leaves(fn(tcfg, tp, ti))
        assert set(got) == set(want)
        bad = {p: (got[p], want[p]) for p in got
               if _norm(got[p]) != _norm(want[p])}
        assert not bad, (fn.__name__, list(bad.items())[:5])


def _bytes(shape, spec, sizes, itemsize=2):
    n = 1
    for e in spec:
        for a in spec_axes(e if not isinstance(e, tuple) else tuple(e)):
            n *= sizes[a]
    return int(np.prod(shape)) * itemsize // n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_fsdp_holds_the_reference_bytes_per_layer_group(abstract, arch,
                                                        mesh):
    """The fsdp variant: for each leaf name of each layer group (the
    reference's stacked ``layers_scan/pos{p}`` leaf, or a tail layer's),
    one device holds as many bytes under the port's per-layer placement
    as under the reference's stacked one."""
    cfg, tcfg = get_config(arch), torch_config(arch)
    ri, ti = _infos(MESHES[mesh], global_batch=256, fsdp_params=True)
    shape, axes = PRODUCTION[MESHES[mesh]]
    sizes = dict(zip(axes, shape))
    rp, tp = abstract[arch]
    rspec, tspec = ref_sh.param_pspecs(cfg, rp, ri), sh.param_pspecs(
        tcfg, tp, ti)
    plen = len(cfg.block_pattern)
    n_full = cfg.num_layers // plen
    checked = 0
    for group, rtree in list(rspec["layers_scan"].items()) + [
            (f"tail{i}", t) for i, t in enumerate(rspec["layers_tail"])]:
        if group.startswith("pos"):
            layers = [c * plen + int(group[3:]) for c in range(n_full)]
            rleaves = rp["layers_scan"][group]
        else:
            layers = [n_full * plen + int(group[4:])]
            rleaves = rp["layers_tail"][int(group[4:])]
        for part in rtree:
            for name, spec in rtree[part].items():
                want = _bytes(rleaves[part][name].shape, spec, sizes)
                got = sum(_bytes(tp["layers"][i][part][name].shape,
                                 tspec["layers"][i][part][name], sizes)
                          for i in layers)
                assert got == want, (group, part, name, got, want)
                checked += 1
    for name in ("embed", "lm_head", "frontend"):
        if name in rspec:
            assert _bytes(tp[name].shape, tspec[name], sizes) == _bytes(
                rp[name].shape, rspec[name], sizes)
    assert checked


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    cfg, tcfg = get_config(arch), torch_config(arch)
    for shape in ("decode_32k", "long_500k", "train_4k", "prefill_32k"):
        ishape = ref_inputs.INPUT_SHAPES[shape]
        ri, ti = _infos(MESHES[mesh], global_batch=ishape.global_batch)
        shard = bool(ri.batch_axes)
        rb = ref_inputs.batch_specs(cfg, ishape)
        tb = input_specs.batch_specs(tcfg, input_specs.INPUT_SHAPES[shape])
        want = ref_sh.batch_pspecs(cfg, rb, ri, shard)
        got = sh.batch_pspecs(tcfg, tb, ti, shard)
        assert {k: _norm(v) for k, v in got.items()} == {
            k: _norm(v) for k, v in want.items()}
        if ishape.kind != "decode" or ref_inputs.applicable(cfg, ishape):
            continue
        B, S = ishape.global_batch, ishape.seq_len
        rc = jax.eval_shape(lambda: ref_init_cache(cfg, B, S, jnp.bfloat16))
        rs = ref_sh.cache_pspecs(cfg, rc, ri, shard)
        tc = init_cache(tcfg, B, S, torch.bfloat16, "meta")
        ts = sh.cache_pspecs(tcfg, tc, ti, shard)
        kinds = layer_kinds(tcfg)
        plen = len(cfg.block_pattern)
        for p in range(plen):
            for key, spec in rs["scan"][f"pos{p}"].items():
                tkey = CACHE_KEYS[cfg.block_pattern[p]][key]
                assert _norm(ts[tkey][1:]) == _norm(tuple(spec)[1:]), (
                    p, key)
        for i, tail in enumerate(rs["tail"]):
            kind = kinds[(cfg.num_layers // plen) * plen + i]
            for key, spec in tail.items():
                assert _norm(ts[CACHE_KEYS[kind][key]][1:]) == _norm(
                    tuple(spec)), (i, key)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_shapes_applicable_and_model_flops_equal_the_reference(arch):
    assert {k: dataclasses.asdict(v)
            for k, v in input_specs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v)
        for k, v in ref_inputs.INPUT_SHAPES.items()}
    cfg, tcfg = get_config(arch), torch_config(arch)
    for name, shape in input_specs.INPUT_SHAPES.items():
        rshape = ref_inputs.INPUT_SHAPES[name]
        assert input_specs.applicable(tcfg, shape) == \
            ref_inputs.applicable(cfg, rshape)
        assert dryrun_lib.model_flops(tcfg, shape) == \
            ref_dryrun.model_flops(cfg, rshape)
        rb = ref_inputs.batch_specs(cfg, rshape)
        tb = input_specs.batch_specs(tcfg, shape)
        assert {k: tuple(v.shape) for k, v in tb.items()} == {
            k: tuple(v.shape) for k, v in rb.items()}
        assert all(v.device.type == "meta" for v in tb.values())


def test_fit_spec_replicates_what_does_not_divide():
    """qwen1.5-32b's 40 heads on the 16-way model axis: the projection's
    5120 columns divide (so wq shards), its heads do not (so attention
    replicates them), as ``head_axis`` decides."""
    from repro_torch.models.layers import head_axis
    _, ti = _infos(False, global_batch=256)
    spec = sh.fit_spec(sh.P(None, "model"), (5120, 5120), ti)
    assert tuple(spec) == (None, "model")
    assert head_axis(ti, 40) is None and head_axis(ti, 32) == "model"
    assert tuple(sh.fit_spec(sh.P("model", None), (40, 128), ti)) == (
        None, None)
