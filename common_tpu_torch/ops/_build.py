"""Build the hand-written CUDA kernels (`csrc/`) at first use and load them.

`nvcc` compiles every source in `csrc/` into one shared library with a
plain C interface, which ctypes loads. Nothing includes PyTorch's headers,
so the build takes seconds. The library goes into `common_tpu_torch/_build/`
under a name keyed by a hash of the sources, so an edited source builds
anew and an unchanged one is reused. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# seconds the last call to `library()` spent building (0.0 when reused)
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gaussian_assign_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.gaussian_assign_launch.restype = ci
    lib.gaussian_assign_max_dim.argtypes = []
    lib.gaussian_assign_max_dim.restype = ci
    lib.scatter_stats_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.scatter_stats_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built from `csrc/` if not built yet."""
    global build_seconds
    out = BUILD_DIR / f"libcommon_tpu_torch_{_digest()}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
            "-o", str(tmp), *[str(s) for s in sorted(CSRC.glob("*.cu"))],
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return _declare(ctypes.CDLL(str(out)))


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
