"""Bulk text ingest: CSV/TSV of numbers to a float32 matrix (port of
`common_tpu/io/loader.py`).

    X = load_csv_f32("rows.csv")          # [N, D] float32, C-contiguous
    data = ((torch.from_numpy(X).to(dev), torch.ones(len(X), device=dev)),)

The parse runs in the port's own multithreaded C++ parser
(`common_tpu_torch/native/loader.cpp`), which g++ builds at first use into
`common_tpu_torch/_build/` under a name keyed by a hash of the source, as
`ops/_build.py` does for the CUDA kernels. If a C++ compiler is on PATH, a
failed build raises. Only where none is found does `load_csv_f32` parse
with numpy (`load_csv_f32_plain`, the JAX package's pure-numpy route).
Both routes round each field to the nearest double and then to float32,
so they give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def compiler():
    """The C++ compiler on PATH ($CXX, else g++, else c++), or None."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


@functools.lru_cache(maxsize=None)
def library():
    """The parser's shared library, built from `native/loader.cpp` if not built yet."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH to build the CSV parser")
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libcsv_loader_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *_CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.ct_csv_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
    lib.ct_csv_shape.restype = ctypes.c_long
    lib.ct_csv_load_f32.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_long, ctypes.c_int]
    lib.ct_csv_load_f32.restype = ctypes.c_long
    return lib


def load_csv_f32_native(path, n_threads: int = 0) -> np.ndarray:
    """`load_csv_f32` through the C++ parser (built at first use)."""
    lib = library()
    name = os.fsencode(path)
    cols = ctypes.c_long(0)
    rows = lib.ct_csv_shape(name, ctypes.byref(cols))
    if rows == -1:
        raise FileNotFoundError(path)
    if rows == -2:
        return np.empty((0, 0), np.float32)
    out = np.empty((rows, cols.value), np.float32)
    got = lib.ct_csv_load_f32(name, out.ctypes.data, rows, cols.value, n_threads)
    if got == -3:
        raise ValueError(f"{path}: ragged rows or unparseable fields "
                         f"(expected {cols.value} columns per line)")
    if got < 0:
        raise OSError(f"{path}: csv parse failed ({got})")
    return out[:got]


def load_csv_f32_plain(path) -> np.ndarray:
    """The numpy route: `np.loadtxt` with the first data line's separator."""
    first = ""
    with open(path) as f:
        for line in f:
            if line.strip() and not line.lstrip().startswith("#"):
                first = line
                break
    delim = "," if "," in first else (";" if ";" in first else None)
    arr = np.loadtxt(path, dtype=np.float32, comments="#", delimiter=delim, ndmin=2)
    return np.ascontiguousarray(arr, np.float32)


def load_csv_f32(path, n_threads: int = 0) -> np.ndarray:
    """Parse a CSV/TSV of numbers into a C-contiguous [rows, cols] float32 array.

    Separators: comma, semicolon, tab and space; '#' comments and blank
    lines are skipped; CRLF line ends are accepted. Raises ValueError on
    ragged rows. n_threads: parser threads (0: one a core). The C++ parser
    runs where a compiler is on PATH (a failed build raises), else numpy.
    """
    if compiler() is None:
        return load_csv_f32_plain(path)
    return load_csv_f32_native(path, n_threads)
