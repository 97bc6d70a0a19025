"""Reproducibility from a seed: where the port may add floats in an order
that changes from call to call, and what the IRM's blocked sweep does with
padding cells.

On a CUDA tensor `index_add_`, `scatter_add_`, `index_put_(accumulate=True)`,
`put_(accumulate=True)`, `scatter_reduce` and `index_reduce` add with
atomics, so a sum of floats lands in another order, and rounds otherwise,
each call. Every such call in `common_tpu_torch/` must stand in the
allow-list below with one of three reasons under which the order cannot
change the result: its target is an integer dtype; its addends are
integer-valued by construction and every sum stays at or below 2^24 at the
sizes the paths run (float32 adds such values exactly in any order); or it
adds into distinct slots, one add a slot. Every other float sum goes through
`utils.segment`. The list is exact both ways: a new call fails the test, and
so does an entry whose call is gone. `torch.use_deterministic_algorithms` is
no repair: it appears neither in the package nor in `chip_smoke.py`.

The cell-sharded IRM sweep at world size 1 (one gloo process) equals
`relational.sweep` bit for bit on the CPU with padding cells (mask 0, index
0, as `shard_cells` appends on a rank) in its views and chunks of a few
cells, so the padding changes neither the order nor the value of entity
0's sums.
"""

import ast
import pathlib

import pytest
import torch

import torch_dist_workers as W
from common_tpu_torch import relational as irm
from common_tpu_torch.relational import kernels

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "common_tpu_torch"

INTEGER = "integer target dtype"
EXACT = "integer-valued addends, every sum at most 2^24"
DISTINCT = "distinct slots, one add a slot"

# (file, enclosing function, method) -> (calls, reason)
ALLOWED = {
    ("state.py", "_assignment_counts", "scatter_add_"): (1, INTEGER),     # int64 counts
    ("state.py", "remove_value_", "index_add_"): (1, INTEGER),            # int32 counts
    ("state.py", "add_value_", "index_add_"): (1, INTEGER),               # int32 counts
    ("kernels/smc.py", "_slot_counts", "scatter_add_"): (1, INTEGER),     # int32 counts
    ("relational/kernels.py", "_remove_and_score", "index_add_"): (1, INTEGER),  # int32 counts
    ("relational/kernels.py", "_add", "index_add_"): (1, INTEGER),        # int32 counts
    # HDP count tables: ones into float32 slots; a slot holds at most a topic's
    # tokens (phase 10 of chip_smoke.py requires its largest below 2^24)
    ("topic/hdp.py", "_segment_count", "index_add_"): (1, EXACT),
    ("ops/hdp_assign.py", "hdp_assign_plain", "scatter_add_"): (1, EXACT),
    # one row's contribution into each of M distinct slots
    ("likelihoods/base.py", "scatter_fold_", "index_add_"): (1, DISTINCT),
}

ATOMIC = {"index_add_", "index_add", "scatter_add_", "scatter_add", "scatter_reduce_", "scatter_reduce",
          "index_reduce_", "index_reduce"}
ACCUMULATING = {"index_put_", "index_put", "put_", "put"}  # atomic only with accumulate=True


def _accumulates(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "accumulate":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is False)
    return any(isinstance(a, ast.Constant) and a.value is True for a in call.args)


def _sites():
    """{(file, enclosing function, method): calls} of every atomic add in the package."""
    found = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE).as_posix()

        def visit(node, func):
            for child in ast.iter_child_nodes(node):
                name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
                if (isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute)
                        and not (isinstance(child.func.value, ast.Name) and child.func.value.id in ("np", "numpy"))):
                    method = child.func.attr
                    weighted = method == "bincount" and any(kw.arg == "weights" for kw in child.keywords)
                    if method in ATOMIC or weighted or (method in ACCUMULATING and _accumulates(child)):
                        key = (rel, func, method)
                        found[key] = found.get(key, 0) + 1
                visit(child, name)

        visit(ast.parse(path.read_text()), "<module>")
    return found


def test_every_atomic_add_is_allowed_with_its_reason():
    found = _sites()
    assert {k: n for k, (n, _) in ALLOWED.items()} == found
    assert {reason for _, reason in ALLOWED.values()} <= {INTEGER, EXACT, DISTINCT}


@pytest.mark.parametrize("where", ["common_tpu_torch", "chip_smoke.py"])
def test_no_deterministic_mode(where):
    paths = [ROOT / where] if where.endswith(".py") else sorted((ROOT / where).rglob("*.py"))
    for path in paths:
        assert "use_deterministic_algorithms" not in path.read_text(), path


def _padded(views, pad: int):
    """Each view with `pad` cells of mask 0 and index 0 appended (what
    `shard_cells` gives a rank whose slice ends past the last cell)."""
    out = []
    for v in views:
        def grow(t):
            return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])

        out.append(irm.RelView(grow(v.indices), grow(v.values), grow(v.mask)))
    return tuple(out)


@pytest.mark.parametrize("table_elems", [12, 1 << 25])
def test_sharded_sweep_with_padding_cells_equals_the_sweep(monkeypatch, table_elems):
    """3 sharded sweeps at world size 1 over views padded with 5 cells equal
    3 `relational.sweep` sweeps over the plain views bit for bit (state and
    generator), with chunks of 2-4 cells (entities split across chunks) and
    with one chunk; so does the blocked table of padded views alone."""
    monkeypatch.setattr(kernels, "TABLE_ELEMS", table_elems)
    rels, defn = W.irm_problem()
    views = W.irm_views(rels)
    one = s = W.irm_init(defn, views, 0)
    theta = kernels._sample_block_params(s, torch.Generator().manual_seed(9))
    padded = _padded(views, 5)
    for d in range(defn.ndomains):
        assert torch.equal(kernels._domain_loglik_table(s, padded, theta, d),
                           kernels._domain_loglik_table(s, views, theta, d))
    g_sharded, g_one = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    with W.one_process_group() as mesh:
        local = _padded(kernels.shard_cells(mesh, views), 5)
        sweep = kernels.make_sharded_sweep(mesh, s, local)
        for _ in range(3):
            s, one = sweep(s, local, g_sharded), kernels.sweep(one, views, g_one)
    for x, y in zip(s.assignments + s.counts, one.assignments + one.counts):
        assert torch.equal(x, y)
    for a, b in zip(s.suffstats, one.suffstats):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(g_sharded.get_state(), g_one.get_state())
