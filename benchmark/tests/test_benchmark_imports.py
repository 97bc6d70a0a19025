"""What the benchmark imports, and what it does without a card.

Module names are compared by their top-level name, whole: `common_tpu_torch`
(the program) is not `common_tpu` (the JAX package), though it begins so.
"""

from __future__ import annotations

import os
import subprocess
import sys

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "common_tpu"}
ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(run.ROOT)}
ENV.pop("JAX_PLATFORMS", None)


def _imported(code: str) -> set:
    """Top-level names of the modules `python -X importtime -c code` imports."""
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", code], cwd=run.ROOT, env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set()
    for line in out.stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            module = line.rsplit("|", 1)[1].strip()
            if module and module != "package":
                names.add(module.split(".")[0])
    return names


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "dpmm_niw_1m_d256.fused",
                          "--seed", str(2**31 + 12345), "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """A whole run of a tiny cell on the CPU (set-up, window, trace, comparison)
    loads nothing whose top-level name is jax, jaxlib, flax or common_tpu."""
    code = (
        "import json, torch\n"
        "from benchmark import run\n"
        "from benchmark.tests.conftest import tiny_spec\n"
        "for cell in ('dpmm_niw_1m_d256.fused', 'dpmm_bbv_100k_d64.slice_hp', 'dpmm_niw_1m_d256.smc',\n"
        "             'dpmm_niw_1m_d256.chains4'):\n"
        "    for trace in (False, True):\n"
        "        run.run_cell(tiny_spec(cell), 5, 0.2, trace, torch.device('cpu'))\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    names = _imported(code)
    assert "common_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = _imported("import benchmark.reference.niw, benchmark.reference.bbv, "
                      "benchmark.reference.philox, benchmark.reference.compare, "
                      "benchmark.reference.precision, benchmark.reference.slice, "
                      "benchmark.reference.sticks")
    assert not names & (FORBIDDEN | {"common_tpu_torch"}), names


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["common_tpu_torch", "common_tpu_torch.runner", "torch"]) == []
    assert run.forbidden_modules(["common_tpu_torch", "common_tpu.models", "jaxlib.xla"]) == [
        "common_tpu", "jaxlib"]


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a run
    prints no result and exits non-zero."""
    import shutil

    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in ENV.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "dpmm_niw_1m_d256.fused",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
