"""The port's cell-sharded IRM sweep (`relational/kernels.py`
`shard_cells`, `make_sharded_sweep`) against `relational.sweep` and the JAX
package.

Ranks are CPU processes over gloo, spawned with `torch.multiprocessing`
(`torch_dist_workers.py`, which imports no JAX), each spawn with its own
timeout. The checks of tests/test_irm.py's sharded tests:

- at world size 1 the sharded sweep equals `relational.sweep` bit for bit;
- after 4 sweeps on 2 ranks of a problem with three domains, a bb and a gp
  relation and missing cells: assignments, counts, suffstats and the
  generator identical on both ranks, the suffstats equal to the port's
  and the JAX package's `compute_relation_stats` of the final assignments
  (exactly where the leaf holds integers; gp's sum of log x! at rtol 1e-6,
  float32 sums in another order), and the ranks' cells equal to
  the JAX `shard_cells` padding of the same relations;
- on 2 ranks the chain over a 3 x 3 bipartite relation matches the exact
  posterior over both partitions (KL < 0.05);
- a self-relation is refused.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from common_tpu import models as jmodels
from common_tpu import parallel as jparallel
from common_tpu import relational as jirm
from common_tpu import testutil
from common_tpu.data.sparse import sparse_ndarray_dataview as j_sparse
from common_tpu_torch import models
from common_tpu_torch import relational as irm
from common_tpu_torch.data import sparse_ndarray_dataview
from common_tpu_torch.parallel import mesh as mesh_mod
from common_tpu_torch.relational import kernels

from test_torch_irm import _exact

torch.set_num_threads(2)


def _equal_irm(a, b):
    for x, y in zip(a.assignments + a.counts, b.assignments + b.counts):
        assert torch.equal(x, y)
    for sa, sb in zip(a.suffstats, b.suffstats):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_world_size_one_equals_the_one_device_sweep():
    """At world size 1 the all_reduces are the identity: 4 sharded sweeps
    equal 4 `relational.sweep` sweeps bit for bit, generators included."""
    rels, defn = W.irm_problem()
    views = W.irm_views(rels)
    one = s = W.irm_init(defn, views, 0)
    g_sharded, g_one = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    with W.one_process_group() as mesh:
        local = kernels.shard_cells(mesh, views)
        sweep = kernels.make_sharded_sweep(mesh, s, local)
        for _ in range(4):
            s, one = sweep(s, local, g_sharded), kernels.sweep(one, views, g_one)
            _equal_irm(s, one)
    assert torch.equal(g_sharded.get_state(), g_one.get_state())


def test_two_ranks_keep_the_stats_and_match_jax(tmp_path, cpu_devices):
    """tests/test_irm.py's sharded invariants on 2 ranks (see the module
    docstring); the cell counts are odd, so the padding is exercised."""
    out = str(tmp_path / "irm")
    W.spawn(W.irm_sharded_checks, 2, tmp_path, out)
    res = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(2)]
    rels, defn = W.irm_problem()
    views = W.irm_views(rels)
    assert any(v.indices.shape[0] % 2 for v in views)
    for name in res[0]:
        if not name.startswith(("indices", "values", "mask")):
            np.testing.assert_array_equal(res[0][name], res[1][name], err_msg=name)
    # the ranks' cells are the JAX package's padded cells, in order
    jviews = [j_sparse(dense=v, missing_mask=m) for v, m in rels]
    mesh = jparallel.make_mesh(chains=1, data=2, devices=cpu_devices[:2])
    for r, jv in enumerate(jirm.kernels.shard_cells(mesh, jviews)):
        for name, whole in (("indices", jv.indices), ("values", jv.values), ("mask", jv.mask)):
            np.testing.assert_array_equal(np.concatenate([x[f"{name}{r}"] for x in res]), np.asarray(whole))
    # the reduced suffstats are those of the final assignments, in both packages
    z = [res[0][f"z{d}"] for d in range(defn.ndomains)]
    for d, zd in enumerate(z):
        np.testing.assert_array_equal(res[0][f"counts{d}"], np.bincount(zd, minlength=defn.k_maxes[d]))
    final = irm.initialize(defn, views, torch.Generator().manual_seed(0),
                           cluster_hps=[{"alpha": 1.0}] * defn.ndomains,
                           domain_assignments=z)
    jdefn = jirm.model_definition([12, 9, 5], [((0, 1), jmodels.bb), ((2, 1), jmodels.gp)], k_max=[5, 4, 3])
    js = jirm.initialize(jdefn, jviews, jax.random.key(0), cluster_hps=[{"alpha": 1.0}] * 3,
                         domain_assignments=z)
    for r in range(len(rels)):
        for k, v in final.suffstats[r].items():
            got = res[0][f"stats{r}_{k}"]
            for want in (v.numpy(), np.asarray(js.suffstats[r][k])):
                if np.all(np.mod(want, 1) == 0):  # counts and sums of integers: exact
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:  # gp's sum of log x!: float32 sums in another order
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)


def test_two_ranks_match_enumeration(tmp_path):
    """tests/test_irm.py:278 on 2 ranks: a 3 x 3 bipartite bb relation
    (9 cells, padded to 10), k_max 4, alpha 1; the joint posterior over
    both partitions, KL < 0.05 at 3000 samples past 100 sweeps."""
    rel = (np.random.default_rng(1).random((3, 3)) < 0.5).astype(np.float32)
    exact = _exact(rel, (0, 1), (3, 3), 4, 1.0)
    cache = {}

    def sample_fn(n):
        if n not in cache:
            out = str(tmp_path / f"oracle{len(cache)}")
            W.spawn(W.irm_oracle_samples, 2, tmp_path, out, rel, 4, 1.0, n + 100, 7 + len(cache))
            zs = np.load(f"{out}.npy")[100:]
            cache[n] = [(testutil.permutation_canonical(z[:3]), testutil.permutation_canonical(z[3:]))
                        for z in zs]
        return cache[n]

    testutil.assert_discrete_dist_approx(sample_fn, exact, nsamples=3000, ntries=3, kl_tol=0.05)


def test_self_relations_are_refused_and_cells_pad():
    """A domain on both axes of a relation needs the sequential loop over
    all its cells: `make_sharded_sweep` raises, as in the JAX package. On
    rank 1 of 3, `shard_cells` keeps cells 3-5 of 7 padded to 9 and the
    last rank the padding, mask 0 and index 0."""
    rel = (np.random.default_rng(0).random((4, 4)) < 0.5).astype(np.float32)
    defn = irm.model_definition([4], [((0, 0), models.bb)], k_max=5)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel, device="cpu")])
    s = irm.initialize(defn, views, torch.Generator().manual_seed(0), cluster_hps=[{"alpha": 1.0}])
    fake = mesh_mod.Mesh((1, 3), 0, 1, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="self-relation"):
        kernels.make_sharded_sweep(fake, s, views)
    view = irm.RelView(torch.arange(14).reshape(7, 2), torch.ones(7), torch.ones(7))
    (mid,) = kernels.shard_cells(fake, [view])
    assert torch.equal(mid.indices, view.indices[3:6]) and torch.equal(mid.mask, torch.ones(3))
    (last,) = kernels.shard_cells(mesh_mod.Mesh((1, 3), 0, 2, None, torch.device("cpu")), [view])
    assert torch.equal(last.mask, torch.tensor([1.0, 0.0, 0.0]))
    assert torch.equal(last.indices[1:], torch.zeros((2, 2), dtype=torch.int64))
