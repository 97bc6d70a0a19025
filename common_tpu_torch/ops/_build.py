"""Build the hand-written CUDA kernels (`csrc/`) at first use and load them.

`nvcc` compiles each `.cu` source in `csrc/` to an object file, all of them
at once in parallel processes, and links the objects into one shared
library with a plain C interface, which ctypes loads. Nothing includes
PyTorch's headers, so the build takes seconds. The library goes into
`common_tpu_torch/_build/` under a name keyed by a hash of the sources, so
an edited source builds anew and an unchanged one is reused. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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
    lib.gaussian_assign_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.gaussian_assign_launch.restype = ci
    lib.gaussian_assign_max_dim.argtypes = []
    lib.gaussian_assign_max_dim.restype = ci
    lib.gaussian_assign_chains_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.gaussian_assign_chains_launch.restype = ci
    lib.gaussian_assign_wgmma_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.gaussian_assign_wgmma_launch.restype = ci
    lib.gaussian_assign_chains_wgmma_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.gaussian_assign_chains_wgmma_launch.restype = ci
    lib.gaussian_assign_wgmma_max_dim.argtypes = []
    lib.gaussian_assign_wgmma_max_dim.restype = ci
    lib.gaussian_assign_wgmma_smem.argtypes = [ci]
    lib.gaussian_assign_wgmma_smem.restype = ctypes.c_longlong
    lib.gaussian_assign_wgmma_scratch.argtypes = [ci, ci]
    lib.gaussian_assign_wgmma_scratch.restype = ctypes.c_longlong
    lib.scatter_stats_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.scatter_stats_launch.restype = ci
    lib.linear_assign_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.linear_assign_launch.restype = ci
    cf = ctypes.c_float
    lib.slice_update_launch.argtypes = [vp] * 8 + [ci] * 4 + [cf] * 4 + [ci] * 3 + [vp]
    lib.slice_update_launch.restype = ci
    lib.hdp_assign_launch.argtypes = [vp] * 8 + [ci] * 4 + [ctypes.c_longlong, ci, vp]
    lib.hdp_assign_launch.restype = ci
    lib.hdp_assign_max_topics.argtypes = []
    lib.hdp_assign_max_topics.restype = ci
    return lib


def _run_all(cmds):
    """Run the commands in parallel; the (returncode, output) of each, in order."""
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        procs = list(pool.map(lambda c: subprocess.run(c, capture_output=True, text=True), cmds))
    return [(p.returncode, p.stdout + p.stderr) for p in procs]


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built from `csrc/` if not built yet."""
    global build_seconds
    out = BUILD_DIR / f"libcommon_tpu_torch_{_digest()}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        sources = sorted(CSRC.glob("*.cu"))
        objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        compile_cmds = [
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
             "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objects)
        ]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        results = _run_all(compile_cmds)
        if all(rc == 0 for rc, _ in results):
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
            results += _run_all([link])
        build_seconds = time.perf_counter() - t0
        log = "".join(text for _, text in results)
        out.with_suffix(".log").write_text(log)
        for obj in objects:
            obj.unlink(missing_ok=True)
        failed = [rc for rc, _ in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, out)
    return _declare(ctypes.CDLL(str(out)))


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
