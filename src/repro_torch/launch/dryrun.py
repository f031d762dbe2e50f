"""Multi-pod dry-run entry point (``repro.launch.dryrun``).

Runs each (arch x shape) step on a production mesh over the ``fake``
process group (``launch.mesh.make_production_mesh``: 256 ranks for 16x16,
512 for 2x16x16, this process rank 0, meta tensors) and prints its
H100 roofline terms; one JSON file per run goes to ``--out`` (by default
the git-ignored ``build/dryrun``).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all          # full sweep, both meshes
    python -m repro_torch.launch.dryrun --all --arch qwen1.5-32b   # one arch
"""
import argparse
import json
import sys
import time


def _cell(res) -> str:
    """One run as "compute / memory / collective s, dominant, fits"."""
    if res["status"] == "skipped":
        return "skipped"
    if res["status"] != "ok":
        return "error"
    t = res["roofline"]
    return (f"{t['compute_s']:.3g} / {t['memory_s']:.3g} / "
            f"{t['collective_s']:.3g}, {t['dominant']}, "
            f"{'fits' if res['memory']['fits_hbm'] else 'does not fit'}")


def table(results) -> str:
    """A markdown table of a sweep: a row per arch, a column per shape,
    each cell the 16x16 run with the 2x16x16 one in brackets."""
    archs = list(dict.fromkeys(r["arch"] for r in results))
    shapes = list(dict.fromkeys(r["shape"] for r in results))
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in results}
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "| --- |" + " --- |" * len(shapes)]
    for a in archs:
        cells = []
        for sh in shapes:
            one, two = by.get((a, sh, "pod16x16")), by.get(
                (a, sh, "pod2x16x16"))
            if one and two and one["status"] == two["status"] == "skipped":
                cells.append("skipped")
            else:
                cells.append(" [".join(_cell(r) for r in (one, two) if r)
                             + ("]" if one and two else ""))
        lines.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main() -> int:
    from repro_torch.configs import ASSIGNED
    from repro_torch.launch.dryrun_lib import run_dryrun, save_result
    from repro_torch.launch.input_specs import INPUT_SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args()

    if args.all:
        archs = [args.arch] if args.arch else ASSIGNED + ["llama3-8b-sw"]
        combos = [(a, s, mp)
                  for a in archs
                  for s in INPUT_SHAPES
                  for mp in (False, True)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape, args.multi_pod)]

    rc = 0
    t_all = time.time()
    results = []
    for arch, shape, mp in combos:
        res = run_dryrun(arch, shape, multi_pod=mp, variant=args.variant)
        results.append(res)
        path = save_result(res, args.out)
        line = {k: res.get(k) for k in
                ("arch", "shape", "mesh", "status", "compile_seconds")}
        if res["status"] == "ok":
            line["dominant"] = res["roofline"]["dominant"]
            line["fits_hbm"] = res["memory"]["fits_hbm"]
            line["roofline"] = {k: res["roofline"][k] for k in
                                ("compute_s", "memory_s", "collective_s")}
            print(json.dumps(line))
            print(f"  memory: peak={res['memory']['peak_bytes']/1e9:.2f}GB"
                  f"/device")
            print(f"  cost: flops/dev={res['cost']['flops_per_device']:.3e} "
                  f"bytes/dev={res['cost']['bytes_per_device']:.3e} "
                  f"wire/dev={res['cost']['wire_bytes_per_device']:.3e}")
        elif res["status"] == "skipped":
            line["reason"] = res["reason"]
            print(json.dumps(line))
        else:
            line["error"] = res["error"]
            print(json.dumps(line), file=sys.stderr)
            print(res.get("traceback", ""), file=sys.stderr)
            rc = 1
        print(f"  -> {path}", flush=True)
    print(f"dry run: {len(combos)} runs in {time.time() - t_all:.1f} s")
    if len(results) > 1:
        print("H100 roofline terms, compute / memory / collective seconds a "
              "step per device, the dominant one, whether the peak fits "
              "80 GB; 16x16 [2x16x16]:")
        print(table(results))
    return rc


if __name__ == "__main__":
    sys.exit(main())
