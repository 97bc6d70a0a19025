"""The port's CSV loader (`common_tpu_torch/io/loader.py` and its C++ parser
`common_tpu_torch/native/loader.cpp`) against the JAX package's.

On the files of tests/test_native.py (mixed separators with comments and
blank lines, np.savetxt's commas, CRLF) `load_csv_f32` equals
`common_tpu.io.load_csv_f32` exactly (np.array_equal), with 1 and 3 parser
threads; the native and numpy routes give the same bits where numpy reads
the file; ragged rows raise; a failed build raises; with no compiler the
numpy route runs.
"""

import numpy as np
import pytest

from common_tpu.io import load_csv_f32 as jax_load_csv_f32
from common_tpu_torch.io import load_csv_f32
from common_tpu_torch.io import loader


def _mixed(tmp_path):
    """tests/test_native.py:89's file: '#' header, a blank line, rows cycling
    through ', ', ';', tab and space."""
    X = np.random.default_rng(0).normal(size=(500, 7)).astype(np.float32)
    p = tmp_path / "rows.csv"
    with open(p, "w") as f:
        f.write("# header comment\n\n")
        for i, row in enumerate(X):
            sep = [", ", ";", "\t", " "][i % 4]
            f.write(sep.join(f"{v:.7g}" for v in row) + "\n")
    return p, X


def _savetxt(tmp_path):
    """tests/test_native.py:127's file: np.savetxt with commas."""
    X = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    p = tmp_path / "rows2.csv"
    np.savetxt(p, X, delimiter=",", fmt="%.7g")
    return p, X


def _crlf(tmp_path):
    """tests/test_native.py:143's file: CRLF line ends, a comment and a blank line."""
    X = np.random.default_rng(2).normal(size=(30, 4)).astype(np.float32)
    p = tmp_path / "crlf.csv"
    with open(p, "wb") as f:
        f.write(b"# crlf header\r\n\r\n")
        for row in X:
            f.write((",".join(f"{v:.7g}" for v in row)).encode() + b"\r\n")
    return p, X


def _tabs_and_spaces(tmp_path):
    """Wide-range values (exponents -30..30, 17 digits) with tabs and with runs of spaces."""
    r = np.random.default_rng(3)
    X = r.normal(size=(300, 9)) * 10.0 ** r.integers(-30, 30, size=(300, 9))
    p = tmp_path / "wide.tsv"
    np.savetxt(p, X, delimiter="\t", fmt="%.17g")
    q = tmp_path / "wide.txt"
    np.savetxt(q, X, delimiter="   ", fmt="%+.9e")
    return (p, q), X.astype(np.float32)


@pytest.mark.parametrize("n_threads", [1, 3])
def test_loader_equals_the_jax_loader(tmp_path, n_threads):
    files = [_mixed(tmp_path), _savetxt(tmp_path), _crlf(tmp_path)]
    wide, Xw = _tabs_and_spaces(tmp_path)
    files += [(wide[0], Xw), (wide[1], Xw)]
    for path, X in files:
        got = load_csv_f32(str(path), n_threads=n_threads)
        want = jax_load_csv_f32(str(path), n_threads=n_threads)
        assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"] and got.shape == X.shape
        assert np.array_equal(got, want), path.name
        np.testing.assert_allclose(got, X, rtol=1e-6)


def test_native_and_numpy_routes_agree(tmp_path):
    (p, q), _ = _tabs_and_spaces(tmp_path)
    for path in (_savetxt(tmp_path)[0], _crlf(tmp_path)[0], p, q):
        assert np.array_equal(loader.load_csv_f32_native(str(path)), loader.load_csv_f32_plain(str(path)))


def test_ragged_rows_and_missing_files_raise(tmp_path):
    for i, text in enumerate(("1,2,3\n4,5\n", "1,2,3\n4,5,6,7\n", "1,2\n3,x\n", "1,2\n3,4.5q\n")):
        p = tmp_path / f"bad{i}.csv"
        p.write_text(text)
        with pytest.raises(ValueError, match="ragged"):
            load_csv_f32(str(p))
    with pytest.raises(FileNotFoundError):
        load_csv_f32(str(tmp_path / "absent.csv"))
    empty = tmp_path / "empty.csv"
    empty.write_text("# only a comment\n\n")
    assert load_csv_f32(str(empty)).shape == (0, 0)


def test_a_failed_build_raises_and_no_compiler_takes_numpy(tmp_path, monkeypatch):
    p, X = _savetxt(tmp_path)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    loader.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            load_csv_f32(str(p))
    finally:
        loader.library.cache_clear()
    monkeypatch.setattr(loader, "compiler", lambda: None)
    got = load_csv_f32(str(p))
    assert np.array_equal(got, loader.load_csv_f32_plain(str(p)))
