"""Package-level properties of the port: no JAX, fp32 policy, generators, build."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from common_tpu_torch import models, rng
from common_tpu_torch import state as st
from common_tpu_torch import validator
from common_tpu_torch.kernels import blocked
from common_tpu_torch.ops import _build
from common_tpu_torch.rng import beta, gumbel, gumbel_argmax, uniform_open

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import common_tpu_torch, common_tpu_torch.runner, common_tpu_torch.convert\n"
        "import common_tpu_torch.kernels.blocked, common_tpu_torch.ops._build\n"
        "import common_tpu_torch.kernels.slice_, common_tpu_torch.ops.linear_assign\n"
        "import common_tpu_torch.parallel, common_tpu_torch.utils.diagnostics\n"
        "import common_tpu_torch.scalar_functions, common_tpu_torch.likelihoods.bbv\n"
        "import common_tpu_torch.kernels.gibbs, common_tpu_torch.io, common_tpu_torch.io.checkpoint\n"
        "import common_tpu_torch.query, common_tpu_torch.data, common_tpu_torch.data.recarray\n"
        "import common_tpu_torch.likelihoods.bb, common_tpu_torch.likelihoods.bbnc\n"
        "import common_tpu_torch.likelihoods.bnb, common_tpu_torch.likelihoods.dd\n"
        "import common_tpu_torch.likelihoods.dm, common_tpu_torch.likelihoods.gp\n"
        "import common_tpu_torch.likelihoods.nich, common_tpu_torch.kernels.smc\n"
        "import common_tpu_torch.kernels.splitmerge, common_tpu_torch.kernels.annealing\n"
        "import common_tpu_torch.kernels.hmc, common_tpu_torch.kernels.svi\n"
        "import common_tpu_torch.likelihoods.expfam\n"
        "import common_tpu_torch.topic, common_tpu_torch.topic.hdp, common_tpu_torch.topic.svi\n"
        "import common_tpu_torch.data.variadic, common_tpu_torch.utils.util\n"
        "import common_tpu_torch.utils.profiling\n"
        "import common_tpu_torch.relational, common_tpu_torch.relational.state\n"
        "import common_tpu_torch.relational.kernels, common_tpu_torch.data.sparse\n"
        "import common_tpu_torch.parallel.mesh, common_tpu_torch.parallel.sharded\n"
        "import common_tpu_torch.parallel.scaling, common_tpu_torch.io.loader\n"
        "import common_tpu_torch.kernels, common_tpu_torch.utils, common_tpu_torch.examples\n"
        "import common_tpu_torch.examples.dpmm, common_tpu_torch.examples.binary_matrix\n"
        "import common_tpu_torch.examples.multichain_heldout, common_tpu_torch.examples.smc_evidence\n"
        "import common_tpu_torch.examples.lda_topics, common_tpu_torch.examples.irm_links\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'common_tpu.')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_kernels_and_utils_export_the_reference_names():
    """`common_tpu_torch.kernels` has the JAX package's six kernel modules as
    attributes, `common_tpu_torch.utils` its four util functions and
    `common_tpu_torch.ops` its kernel entry point, in a fresh process that
    imports no JAX."""
    code = (
        "import sys, types\n"
        "from common_tpu_torch.ops import fused_gaussian_assign\n"
        "import common_tpu_torch.kernels as k\n"
        "from common_tpu_torch.utils import logsumexp, almost_eq\n"
        "from common_tpu_torch.utils import random_assignment_vector, random_orthonormal_matrix\n"
        "mods = [getattr(k, n) for n in ('blocked', 'gibbs', 'hmc', 'slice_', 'smc', 'svi')]\n"
        "assert all(isinstance(m, types.ModuleType) for m in mods)\n"
        "assert k.smc.__name__ == 'common_tpu_torch.kernels.smc'\n"
        "import torch\n"
        "assert abs(float(logsumexp(torch.zeros(4))) - float(torch.log(torch.tensor(4.0)))) < 1e-6\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'common_tpu.')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "scripts/kernel_turns.py",
                                    "scripts/assign_tilings.py", "scripts/linear_variants.py",
                                    "scripts/irm_determinism.py", "scripts/segment_probes.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts that run on the card import neither JAX nor the JAX package."""
    import ast

    names = set()
    for node in ast.walk(ast.parse((REPO / script).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "torch" in tops and not tops & {"jax", "jaxlib", "common_tpu"}, sorted(tops)


def test_tf32_is_off_and_the_sweeps_refuse_it():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    defn = st.model_definition(20, [models.niw(2)], k_max=4)
    data = ((torch.randn(20, 2), torch.ones(20)),)
    s = st.initialize(defn, data, rng(0, "cpu").generator)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for sweep in (blocked.sweep, blocked.sweep_fused, blocked.sweep_chains):
            with pytest.raises(RuntimeError, match="allow_tf32"):
                sweep(s, data, rng(1, "cpu").generator)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_gumbel_draws_are_finite_and_skip_masked_logits():
    g = rng(0, "cpu").generator
    u = uniform_open((200000,), g)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert torch.isfinite(gumbel((200000,), g)).all()
    logits = torch.tensor([0.0, -torch.inf, 1.0, -torch.inf])
    z = gumbel_argmax(logits.expand(5000, 4), g)
    assert set(z.unique().tolist()) <= {0, 2}
    freq = (z == 2).double().mean().item()
    assert abs(freq - np.exp(1) / (1 + np.exp(1))) < 0.03


def test_beta_draws_mean():
    g = rng(2, "cpu").generator
    a, b = torch.full((20000,), 2.0), torch.full((20000,), 5.0)
    v = beta(a, b, g)
    assert abs(v.mean().item() - 2.0 / 7.0) < 0.01


def test_rng_handle_and_validation():
    h = rng(5, "cpu")
    assert h.device == torch.device("cpu") and "seed=5" in repr(h)
    a = torch.rand(3, generator=h.generator)
    b = torch.rand(3, generator=rng(5, "cpu").generator)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        rng(1.5, "cpu")
    with pytest.raises(ValueError):
        models.niw(0)
    with pytest.raises(ValueError):
        validator.validate_one_of("x", ("a", "b"), "kernel name")
    defn = st.model_definition(4, [models.niw(2)], k_max=3)
    with pytest.raises(ValueError, match="data columns"):
        st.initialize(defn, (), rng(0, "cpu").generator)


def test_build_is_keyed_by_the_sources():
    names = [p.name for p in _build._sources()]
    for src in ("gaussian_assign.cu", "suffstat.cu", "linear_assign.cu", "philox.cuh", "tf32x3.cuh"):
        assert src in names
    digest = _build._digest()
    assert len(digest) == 16 and digest == _build._digest()
    assert "sm_90a" in " ".join(_build.ARCH_FLAGS)
