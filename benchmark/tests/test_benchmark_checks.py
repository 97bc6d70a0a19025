"""The comparison that decides `correct`: sound runs pass, the control and planted faults fail.

On the CPU at a test's size the program runs its kernels' plain versions,
which draw their noise from a CPU generator; the reference works that noise
out again as it works out the kernels' Philox noise on the card. The run
skips the harness's look for a card (`run_cell` on the CPU) and is otherwise
a whole run: set-up, window, comparison. The control's test at the cells'
own size runs on the card only.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import tiny_spec

CELLS = ["dpmm_niw_1m_d256.fused", "dpmm_bbv_100k_d64.slice_hp", "dpmm_niw_1m_d256.smc",
         "dpmm_niw_1m_d256.chains4"]
CPU = torch.device("cpu")
SEED = 2**31 + 777


def _run(cell, modes=("program",), n=None):
    return run.run_cell(tiny_spec(cell, n), SEED, 0.3, False, CPU, modes)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_on_the_cpu(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    if "assign_gap" in out["checks"]:
        assert out["readings"]["program"]["assign_gap"] == 0.0  # the plain path's draw, worked out again


@pytest.mark.parametrize("cell", ["dpmm_niw_1m_d256.fused", "dpmm_bbv_100k_d64.slice_hp",
                                  "dpmm_niw_1m_d256.smc"])
def test_control_is_not_correct_on_the_cpu(cell):
    """The reference in TF32 put in the program's place fails the comparison
    (its joint score, at a test's size; at the cells' size its draw too)."""
    out = _run(cell, ("control",), n=20000)
    assert not out["correct"], out["checks"]


def _half_batch(fn):
    """A sweep whose restat leaves out half of the rows and doubles the rest."""
    def wrapped(state, data, *args, **kwargs):
        s = fn(state, data, *args, **kwargs)
        x = data[0][0]
        half = x.shape[0] // 2
        w = 2.0 * (s.assignments[..., :half, None] == torch.arange(s.k_max)).to(x.dtype)  # [.., half, K]
        xh = x[:half]
        stats = {"n": w.sum(-2)}
        for leaf in s.stats[0]:
            if leaf in ("sum_x", "heads"):
                stats[leaf] = w.transpose(-1, -2) @ xh
            elif leaf == "sum_xxT":
                stats[leaf] = torch.einsum("...nk,nd,ne->...kde", w, xh, xh)
        return dataclasses.replace(s, counts=stats["n"].to(s.counts.dtype), stats=(stats,))
    return wrapped


def _altered(fn):
    """An assignment kernel whose answer is altered where it is produced."""
    def wrapped(*args, **kwargs):
        z = fn(*args, **kwargs).clone()
        K = args[1].shape[0] if z.dim() == 1 else args[1].shape[0] // z.shape[0]
        z[..., :10] = (z[..., :10] + 1) % K
        return z
    return wrapped


FAULTS = {
    "dpmm_niw_1m_d256.fused": ("sweep_fused", "fused_gaussian_assign"),
    "dpmm_bbv_100k_d64.slice_hp": ("sweep_fused", "fused_linear_assign"),
    "dpmm_niw_1m_d256.chains4": ("sweep_chains", "fused_gaussian_assign_chains"),
}


def _smc_unchanged(fn):
    """A block step that returns its particles unchanged (the increment kept)."""
    def wrapped(parts, *args, **kwargs):
        return parts, fn(parts, *args, **kwargs)[1]
    return wrapped


def _smc_half_batch(fn):
    """The block's suffstats of its first half of the rows, doubled."""
    def wrapped(parts, cols, z, valid, K=None):
        half = valid.clone()
        half[valid.shape[0] // 2:] = False
        return tuple({k: 2.0 * v for k, v in s.items()} for s in fn(parts, cols, z, half, K))
    return wrapped


def _smc_altered(fn):
    """A block step whose seating is altered where it is produced."""
    def wrapped(*args, **kwargs):
        parts, z, incr = fn(*args, **kwargs)
        z = z.clone()
        z[:, :10] = (z[:, :10] + 1) % parts.k_max
        return parts, z, incr
    return wrapped


def _plant_smc(fault, monkeypatch):
    from common_tpu_torch.kernels import blocked, smc

    if fault == "unchanged":
        monkeypatch.setattr(smc, "_absorb_block", _smc_unchanged(smc._absorb_block))
    elif fault == "half_batch":
        monkeypatch.setattr(blocked, "block_stats", _smc_half_batch(blocked.block_stats))
    else:
        monkeypatch.setattr(smc, "_seat_block", _smc_altered(smc._seat_block))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from common_tpu_torch.kernels import blocked

    if cell not in FAULTS:
        _plant_smc(fault, monkeypatch)
        out = _run(cell)
        assert not out["correct"], out["checks"]
        return
    sweep_name, assign_name = FAULTS[cell]
    if fault == "unchanged":
        monkeypatch.setattr(blocked, sweep_name, lambda state, *a, **k: state)
    elif fault == "half_batch":
        monkeypatch.setattr(blocked, sweep_name, _half_batch(getattr(blocked, sweep_name)))
    else:
        monkeypatch.setattr(blocked, assign_name, _altered(getattr(blocked, assign_name)))
    out = _run(cell)
    assert not out["correct"], out["checks"]


def _hp_to_bound(fn):
    """A hyper sampler whose answer is altered where it is produced: every
    Beta hyper it returns moved four times as far from 0, within its bounds."""
    def wrapped(state, data, generator, specs, cluster=None):
        s = fn(state, data, generator, specs, cluster)
        hypers = [{k: (4.0 * v).clamp(*params[k]["bounds"]) if k in params else v
                   for k, v in s.hypers[fid].items()} for fid, params in sorted(specs.items())]
        return dataclasses.replace(s, hypers=tuple(hypers))
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_planted_hyper_fault_is_not_correct(fault, monkeypatch):
    """The slice sampler's faults: a `slice_hp` that returns its state
    unchanged (no coordinate moves), and one whose hypers are altered where
    it returns them (they leave the slices their updates drew)."""
    from common_tpu_torch import runner as runner_mod

    hp = runner_mod.KERNELS["slice_hp"]
    if fault == "unchanged":
        monkeypatch.setitem(runner_mod.KERNELS, "slice_hp", lambda state, *a, **k: state)
    else:
        monkeypatch.setitem(runner_mod.KERNELS, "slice_hp", _hp_to_bound(hp))
    out = _run("dpmm_bbv_100k_d64.slice_hp")
    assert not out["correct"], out["checks"]
    name = "slice_unmoved" if fault == "unchanged" else "slice_level_gap"
    assert out["checks"][name]["value"] == "inf" or out["checks"][name]["value"] > out["checks"][name]["limit"]


def test_wrong_stick_weights_read_far_off():
    """Stick weights that ignore the counts (uniform over the slots) read a
    stick far outside its Beta posterior (`stick_z`, printed, not compared)."""
    from common_tpu_torch.kernels import blocked

    sound = _run("dpmm_niw_1m_d256.fused")["readings"]["program"]["stick_z"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocked, "stick_break_log_weights",
                   lambda g, counts, alpha: torch.full(counts.shape, -math.log(counts.shape[-1])))
        wrong = _run("dpmm_niw_1m_d256.fused")["readings"]["program"]["stick_z"]
    assert sound < 6 < wrong


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell, card):
    """On the card at the cell's own size, three seeds: the program is correct
    and the control is not, in the same runs."""
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = run.run_cell(run.cell_spec(cell), seed, 3.0, False, card, ("program", "control"))
        assert out["correct"], out["checks"]
        ok, checks = run.judge(out["readings"]["control"], run.cell_spec(cell).workload["limits"])
        assert not ok, checks
        torch.cuda.empty_cache()
