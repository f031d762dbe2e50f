"""Where the harness finds what a name in ``BENCHMARK.json`` stands for.

A name's file is ``<kind>/<name>.<ext>`` under the first of ``ROOTS`` that
holds it: ``configs``, ``cells`` and ``traffic`` (``.json``), and the
Python files ``metrics``, ``families`` and ``kernels``, each loaded from
its path, once a process.  A run searches ``ecobench/`` alone; a test puts
a directory of its own first and points ``BENCHMARK`` at its own copy, so
that a configuration, cell, metric or kernel enters by new files only.
Nothing here imports the program.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import Dict

ECO = pathlib.Path(__file__).resolve().parents[1]         # ecobench/
ROOTS = [ECO]
BENCHMARK = ECO.parent / "BENCHMARK.json"

_loaded: Dict[pathlib.Path, ModuleType] = {}


def path(kind: str, name: str, ext: str = ".json") -> pathlib.Path:
    for root in ROOTS:
        p = root / kind / f"{name}{ext}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                            f"{', '.join(str(r) for r in ROOTS)}")


def read_json(kind: str, name: str) -> dict:
    return json.loads(path(kind, name).read_text())


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def _load(kind: str, p: pathlib.Path) -> ModuleType:
    if p not in _loaded:
        tag = re.sub(r"\W", "_", f"ecobench_{kind}_{p.stem}")
        spec = importlib.util.spec_from_file_location(tag, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[p] = mod
    return _loaded[p]


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module."""
    return _load(kind, path(kind, name, ".py"))


def modules(kind: str) -> Dict[str, ModuleType]:
    """Every ``<kind>/*.py`` under ``ROOTS`` by name, sorted; where two
    roots hold one name, the first root's."""
    found: Dict[str, pathlib.Path] = {}
    for root in ROOTS:
        for p in sorted((root / kind).glob("*.py")):
            found.setdefault(p.stem, p)
    return {n: _load(kind, found[n]) for n in sorted(found)}
