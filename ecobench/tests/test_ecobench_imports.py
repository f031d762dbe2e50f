"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is the system, ``repro`` is
not), and the reference side imports nothing of the program."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

from ecobench_testlib import REPO

ECO = REPO / "ecobench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: none of these may import the program (a kernel file's
# ``work`` counts from shapes; ``harness/trace.py`` wraps the program)
REFERENCE_SIDE = ["harness/reference.py", "harness/model.py",
                  "harness/weights.py", "harness/work.py",
                  "harness/traffic.py", "harness/judge.py",
                  "harness/stats.py", "harness/files.py"] + sorted(
    str(p.relative_to(ECO)) for d in ("families", "kernels")
    for p in (ECO / d).glob("*.py"))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ECO))
                                        for p in ECO.rglob("*.py")))
def test_no_jax_in_sources(path):
    assert not set(_imports(ECO / path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE_SIDE)
def test_reference_side_imports_no_program(path):
    assert "repro_torch" not in set(_imports(ECO / path))


def test_no_jax_loaded_after_a_run():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r, %r]\n"
        "from ecobench_testlib import cpu_run, tiny\n"
        "from ecobench.harness.bench import forbidden_modules\n"
        "out = cpu_run('qwen2-72b.longbench', 5, 1.5, True,"
        " shrink=tiny(rate=8.0))\n"
        "print(json.dumps([out['correct'], forbidden_modules()]))\n"
        % (str(REPO / "src"), str(REPO), str(ECO / "tests")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(REPO))
    assert p.returncode == 0, p.stderr[-2000:]
    correct, bad = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct is True and bad == []


def test_forbidden_check_compares_whole_names(monkeypatch):
    from ecobench.harness import bench
    monkeypatch.setitem(sys.modules, "reproducible_fake", object())
    assert "reproducible_fake" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in bench.forbidden_modules()
