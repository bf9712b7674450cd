"""Build and load the port's hand-written CUDA kernels and its host library.

Each ``avdn_tpu_torch/csrc/<name>.cu`` is compiled at first use with ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers: a build takes seconds). Each
``csrc/<name>.cpp`` (the host library, ``avdn_host``) is compiled with the
host C++ compiler and :data:`HOST_FLAGS`: no ``-march`` and no
``-ffast-math``, so no fused multiply-add changes its rounding. Libraries
go to ``build/avdn_tpu_torch/`` at the root of the checkout, named by a hash
of their source and flags, and are built under a file lock and renamed into
place, so concurrent processes share one build and none loads a half-written
file. A failed build raises ``RuntimeError`` with the compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "avdn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> List[str]:
    """Names of every host-library source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cpp"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def host_compiler() -> str:
    """The host C++ compiler that builds ``csrc/*.cpp``."""
    for cand in ("g++", "c++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the host "
                       "library avdn_host is built from csrc/avdn_host.cpp")


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path) -> List[str]:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes() + " ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{name}.{digest.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (the host
    compiler) unless its library is already built; returns the compiler's
    report (nvcc's register and shared-memory use) or ''."""
    out = library_path(name)
    if out.exists():
        return ""
    src = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else host_compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return ""
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        proc = subprocess.run([compiler, *_flags(src), "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed for {src.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return proc.stderr


def build_all() -> Dict[str, str]:
    """Build every kernel source and the host library at once, one compiler
    per source in parallel."""
    names = kernel_sources() + host_sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        reports = list(ex.map(build, names))
    return dict(zip(names, reports))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
