"""Boundaries of the port: ``repro_torch`` (its multi-device layer, dry
run and roofline too), ``chip_smoke.py``, ``profile_port.py``,
``bench_calibration_torch.py`` and ``examples/*_torch.py`` import neither
JAX nor the JAX package, the copied host modules equal their sources up to the
import prefix, and an engine asked for the default device on a machine
without CUDA raises instead of running on the CPU (and both scripts fail
there)."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

# host modules the port keeps as copies of the JAX package's
COPIED = sorted(
    [str(p.relative_to(SRC / "repro")) for p in (SRC / "repro" / "configs")
     .glob("*.py")]
    + [f"core/{m}.py" for m in ("request", "slo", "instance", "constraints",
                                "macro", "mitosis", "policies", "transport",
                                "system", "padg_system")]
    + ["obs/events.py", "faults/policies.py", "simulator/cost_model.py",
       "simulator/engine.py", "serving/replay.py", "data/__init__.py",
       "data/pipeline.py", "simulator/workload.py", "simulator/scenarios.py",
       "serving/calibration.py"]
    + [f"traces/{m}.py" for m in ("__init__", "convert", "stats",
                                  "transforms", "__main__")]
    + [f"obs/{m}.py" for m in ("__init__", "__main__", "export", "metrics")]
    + [f"faults/{m}.py" for m in ("__init__", "injector", "network",
                                  "schedule")]
    + [f"control/{m}.py" for m in ("__init__", "signals", "controller",
                                   "actuator")]
    + [f"baselines/{m}.py" for m in ("__init__", "nodg_vllm",
                                     "nodg_sarathi", "fudg_distserve",
                                     "fudg_mooncake")]
    + [f"fleet/{m}.py" for m in ("__init__", "spec", "router", "system",
                                 "rebalance")]
    + [f"simulator/{m}.py" for m in ("__init__", "metrics", "runner")])


@pytest.mark.parametrize("rel", COPIED)
def test_copies_equal_their_sources(rel):
    src = (SRC / "repro" / rel).read_text()
    assert (SRC / "repro_torch" / rel).read_text() == src.replace(
        "repro.", "repro_torch.")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len(names), {'repro_torch.kernels.rwkv6_scan', "
        "'repro_torch.kernels.rglru_scan', 'repro_torch.serving.api', "
        "'repro_torch.data.pipeline', 'repro_torch.serving.calibration', "
        "'repro_torch.traces.__main__', 'repro_torch.simulator.runner', "
        "'repro_torch.baselines', 'repro_torch.obs.__main__', "
        "'repro_torch.models.shardings', 'repro_torch.models.spmd', "
        "'repro_torch.launch.mesh', 'repro_torch.launch.input_specs', "
        "'repro_torch.launch.steps', 'repro_torch.launch.dryrun_lib', "
        "'repro_torch.launch.dryrun', 'repro_torch.roofline', "
        "'repro_torch.roofline.analysis', 'repro_torch.roofline.op_costs', "
        "'repro_torch.kernels._meta'} "
        "<= set(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, found, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 30 and found == "True" and bad == "[]"


def _top_level_imports(script: str) -> set:
    tree = ast.parse((ROOT / script).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    return {m.split(".")[0] for m in mods}


def test_chip_smoke_imports_neither_jax_nor_repro():
    tops = _top_level_imports("chip_smoke.py")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}


def test_profile_port_imports_neither_jax_nor_repro():
    tops = _top_level_imports("profile_port.py")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}


def test_bench_calibration_torch_imports_neither_jax_nor_repro():
    tops = _top_level_imports("bench_calibration_torch.py")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}


def test_compare_strategies_torch_imports_neither_jax_nor_repro():
    tops = _top_level_imports("examples/compare_strategies_torch.py")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}


@pytest.mark.parametrize("script", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("*_torch.py")))
def test_torch_examples_import_neither_jax_nor_repro(script):
    tops = _top_level_imports(script)
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}


def test_dry_run_and_chip_smoke_load_neither_jax_nor_repro():
    """A dry run on a fake 2x4 mesh (the multi-device layer, the steps,
    the roofline) and importing ``chip_smoke`` leave no JAX and no
    ``repro`` module loaded."""
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "from repro_torch.launch.dryrun_lib import run_dryrun\n"
        "from repro_torch.launch.mesh import init_fake_process_group\n"
        "init_fake_process_group(8)\n"
        "mesh = init_device_mesh('cpu', (2, 4), "
        "mesh_dim_names=('data', 'model'))\n"
        "r = run_dryrun('qwen3-4b', 'decode_32k', mesh=mesh)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(r['status'], bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok []"


def test_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.padg_server import PaDGServer
    from repro_torch.core.slo import SLO
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PaDGServer(cfg, n_instances=1, slo=SLO(ttft=1.0, tpot=1.0))


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_profile_port_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "profile_port.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "flash_prefill" not in out.stdout
