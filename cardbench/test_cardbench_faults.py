"""A whole run on the CPU at the test size, with the timed path broken
underneath, has to come out not correct: once for each fault a cell can
have (no cell spans chips, so no exchange can be left out):
  unchanged  every outer step hands back the state it was given;
  half       half of the batch left out and made up from the rest: the
             second half of the starts reported as the mean of the first
             half's results;
  altered    the answer altered where it is produced: the returned state's
             second factor off by 1 %."""
import time

import numpy as np
import pytest
import torch

from cardbench import tiny
from cardbench.harness import ROOT, load_json, run_cell

torch.set_num_threads(1)
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


def _unchanged(mp):
    from matlab_code_tpu_torch.models import multistart, solver
    orig = solver.make_outer_step

    def make(*a, **k):
        step = orig(*a, **k)

        def broken(state, *rest, **kw):
            return (state,) + tuple(step(state, *rest, **kw)[1:])
        return broken
    mp.setattr(solver, "make_outer_step", make)
    mp.setattr(multistart, "make_outer_step", make)


def _half(mp):
    from matlab_code_tpu_torch.models import multistart
    best = multistart.Lanes.best

    def half_best(self):
        state, out, finals, stops = best(self)
        n = len(finals) // 2
        finals = np.asarray(finals, float).copy()
        finals[n:] = finals[:n].mean()
        return state, out, finals, stops
    mp.setattr(multistart.Lanes, "best", half_best)


def _altered(mp):
    from matlab_code_tpu_torch.models import multistart
    best = multistart.Lanes.best

    def altered_best(self):
        state, out, finals, stops = best(self)
        state.fac[1].mul_(1.01)
        return state, out, finals, stops
    mp.setattr(multistart.Lanes, "best", altered_best)


def _run(cell):
    cfg, traffic = tiny.overrides(cell)
    return run_cell(cell, 2**31 + 101, 0.1, False, time.perf_counter(),
                    device="cpu", cfg_override=cfg, traffic_override=traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif fault == "half":
        _half(monkeypatch)
    else:
        _altered(monkeypatch)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]
