"""Dry-run core (``repro.launch.dryrun_lib``): build one (arch x shape x
mesh) step on meta tensors, run it once under ``OpCosts``, and record its
per-device memory, costs, collectives and H100 roofline terms.

The reference lowers and compiles the step with XLA; the port runs it: on
the production meshes over the ``fake`` process group
(``launch.mesh.make_production_mesh``), where this process plays rank 0,
the tensors are ``meta`` tensors (nothing is allocated, no kernel
launches: the kernels' meta path reports their work), and collectives
return at once.  Every rank runs the same shapes, so rank 0's counts are
every device's.

The step runs in bf16.  The reference lowered in f32 and halved its bytes
(``peak_bytes_bf16_projected``) because the CPU backend legalises bf16
with wholesale f32 conversions; meta tensors have no such legalisation,
so here ``peak_bytes_bf16_projected`` is the tracked peak itself and
``roofline_raw_f32`` equals ``roofline``.  Adam's moments and the
softmax's f32 logits are counted at their own f32 size.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

from repro_torch.configs import get_config
from repro_torch.launch.input_specs import INPUT_SHAPES, applicable
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.roofline.analysis import (H100_SXM, collect_collectives,
                                           roofline_terms)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode D=batch."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens            # forward only
    return 2.0 * n * shape.global_batch    # decode: one token per request


def run_dryrun(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mesh=None,
    variant: str = "baseline",
) -> Dict[str, Any]:
    import torch

    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step)
    from repro_torch.roofline.op_costs import OpCosts

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh_name = "x".join(str(s) for s in mesh.shape)
    n_chips = mesh.size()

    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": n_chips, "variant": variant,
    }
    skip = applicable(cfg, shape)
    if "unroll" in variant:
        # the reference's unroll variant swaps lax.scan over the layers for
        # a Python loop; the port's forward has no scan to swap
        skip = ("variant 'unroll' refused: the port's forward always "
                "loops over its layers in Python, so its baseline run is "
                "the reference's unrolled one")
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result

    mi = mesh_info(mesh, global_batch=shape.global_batch)
    # perf-iteration variants (the reference's)
    if "kv_headdim" in variant:
        mi = dataclasses.replace(mi, kv_shard="head_dim")
    if "fsdp" in variant:
        mi = dataclasses.replace(mi, fsdp_params=True)
    if "remat8" in variant:
        mi = dataclasses.replace(mi, remat_group=8)
    try:
        t0 = time.time()
        dt = torch.bfloat16
        if shape.kind == "train":
            step, args, _ = build_train_step(cfg, mi, shape, dt)
        elif shape.kind == "prefill":
            step, args, _ = build_prefill_step(cfg, mi, shape, dt)
        else:
            step, args, _ = build_decode_step(cfg, mi, shape, dt)
        from repro_torch.params import tree_leaves
        arg_bytes = sum(
            (t.to_local() if hasattr(t, "to_local") else t).numel()
            * t.element_size()
            for t in tree_leaves(args) if isinstance(t, torch.Tensor))
        with OpCosts(live=args) as oc:
            out = step(*args)
        del out
        t_compile = time.time() - t0
        c = oc.costs
        wire_bytes, ops = collect_collectives(c.collective_ops)
        terms = roofline_terms(c.flops, c.hbm_bytes, wire_bytes)
        mf = model_flops(cfg, shape)
        flops_global = c.flops * n_chips
        peak = c.peak_live_bytes

        result.update({
            "status": "ok",
            # building the step's meta arguments and running it once
            "compile_seconds": round(t_compile, 1),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": 0,
                "temp_bytes": peak - arg_bytes,
                "peak_bytes": peak,
                "peak_bytes_bf16_projected": peak,
                "fits_hbm": peak < H100_SXM.hbm_bytes,
            },
            "cost": {
                "flops_per_device": c.flops,
                "bytes_per_device": c.hbm_bytes,
                "wire_bytes_per_device": wire_bytes,
                "aten_ops": c.ops,
                "kernels": c.kernels,
            },
            "roofline": terms,
            "roofline_raw_f32": terms,
            "model_flops": mf,
            "useful_flops_ratio": (mf / flops_global) if flops_global else 0.0,
            "collective_ops": _summarize_collectives(ops),
        })
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return result


def _summarize_collectives(ops):
    summary: Dict[str, Dict[str, float]] = {}
    for op in ops:
        s = summary.setdefault(op["kind"], {"count": 0, "wire_bytes": 0.0})
        s["count"] += op["trips"]
        s["wire_bytes"] += op["wire_bytes"]
    return summary


def save_result(result: Dict[str, Any], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{result['arch']}_{result['shape']}_{result['mesh']}"
            f"_{result.get('variant', 'baseline')}.json")
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return path
