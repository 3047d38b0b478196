"""Build and load the port's hand-written CUDA kernels.

Each ``tdgs_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``tdgs_torch/build/``
(git-ignored) on first use, and loaded with ``ctypes``. A library is
rebuilt when the hash of its source, of the shared ``csrc/*.cuh`` headers
or of the compiler flags changes.
There is no fallback: a failed build raises with the compiler's output.

Every kernel wrapper counts its launches in ``LAUNCHES`` so that a run can
show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> compiler output of the build made in this process
# (-Xptxas=-v: registers, shared memory and spills per kernel)
BUILD_LOGS: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _library_path(name: str) -> Path:
    # the headers of csrc/ count too: a changed .cuh rebuilds every library
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; None when its library is current."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path, out: Path):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOGS[name] = log


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names: Iterable[str] | None = None) -> float:
    """Compile the named kernels (default: every source in csrc/), one
    ``nvcc`` per source, all started together. Returns wall seconds."""
    t0 = time.perf_counter()
    names = kernel_names() if names is None else list(names)
    started = {n: _start_build(n) for n in names}
    for n, job in started.items():
        if job is not None:
            _finish_build(n, *job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, n_ptrs: int, n_ints: int, slots: bool = False):
    """The C entry ``tdgs_<name>`` of ``csrc/<name>.cu``: ``n_ptrs``
    pointers, ``n_ints`` ints, an int64 slot count with ``slots``, then the
    stream; it returns a cudaError_t."""
    fn = getattr(load(name), f"tdgs_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + ([ctypes.c_int64] if slots else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
