"""Build the port's CUDA kernels into one shared library, at first use.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one ``.so`` with
a plain C interface, loaded with ``ctypes``.  The library lives under the
repository's git-ignored ``build/kernels/<hash>/``, keyed on a hash of the
sources and flags, so a checkout builds once and an edited source builds
anew.  Nothing is built or loaded when this module is imported: the CPU
tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (see the extern "C" blocks in csrc/)
SIGNATURES = {
    "flash_prefill_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F, _I, _P),
    "flash_prefill_bwd_launch": (*(_P,) * 12, *(_I,) * 9, _F, _I, _P),
    "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _F, _I, _P),
    "rwkv6_scan_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P),
    "rwkv6_scan_bwd_launch": (*(_P,) * 15, _I, _I, _I, _I, _P),
    "rglru_scan_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rglru_scan_bwd_launch": (*(_P,) * 8, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildInfo:
    """What the last build in this process did (read by chip_smoke.py)."""
    seconds: Optional[float] = None     # None: the library was already built
    log: str = ""                       # nvcc / ptxas output


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> pathlib.Path:
    """Compile and link the library unless this source hash is built."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs = [], []
        for src, obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
            objs.append(str(obj))
        lib = tmp / LIB_NAME
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, out)       # atomic: a concurrent build sees all
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "\n".join(logs)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def wants_grad(*tensors) -> bool:
    """Whether autograd would record a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors, why: str = "") -> None:
    """Raise where autograd would record a kernel's call that has no
    backward kernel (``why`` says for which inputs): an output filled
    through ``ctypes`` carries no ``grad_fn``, so a gradient through it
    would be lost without a word.  The plain versions (CPU tensors) do
    carry gradients."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward{why}; call it under "
            "torch.no_grad() (or on inputs that do not require grad)")
