"""What decides `correct`: one job of the window, drawn from the seed, is
fitted again by the plain reference that the configuration names (its
`reference` key, a module under cardbench/reference/) from the same
inputs, made again by the generator, and the same starting points, drawn
again from the job's keys, in float64.  Compared:

  f_gap      the largest relative gap, over the checked starts, between
             the final f_tensors the program reported for a start and the
             reference's at the same iteration (the reference runs on to
             the program's stopping iteration where its own rule stops it
             earlier);
  f1_gap     the relative gap between the program's f_tensors after the
             first outer iteration of its best start and the reference's;
  fac_gap    the largest relative gap (Frobenius, worst mode) between the
             factors the program returned for its best start and the
             reference's after as many iterations.
Each cell's limits file names the numbers it holds a run to, with the
readings each limit was set from; calibrate.py reads all of them.

A reference module gives init_state(raw, key, dtype, device), the initial
state the program draws for a key, and Reference(raw, options) whose
fit(state0, max_iters, at_least) returns (the history of f_tensors and the
other streams, one row an iteration from 0, the stopping iteration, the
factors after iteration at_least).

The checked starts are the job's best start and, where the traffic mix
checks more (check_starts), others drawn from the seed."""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import torch

from cardbench.generators.common import DTYPES
from cardbench.seeds import derive

ROOT = Path(__file__).resolve().parent.parent


def load_reference(cfg):
    """The reference module the configuration names."""
    path = ROOT / cfg["reference"]
    spec = importlib.util.spec_from_file_location(
        "cardbench.reference." + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes_of(raw):
    """Each dataset's shape and rank, for the counts."""
    return [{"shape": tuple(raw["mode_sizes"][m] for m in d["modes"]),
             "rank": d["rank"]} for d in raw["datasets"]]


@dataclasses.dataclass
class Sample:
    keys: list
    stop_iters: list
    finals: np.ndarray
    best: int
    hist: np.ndarray   # the best start's f_tensors, iteration 0 on
    fac: dict          # the best start's factors, float64

    @classmethod
    def of(cls, job):
        fac = {m: f.detach().to(torch.float64).clone()
               for m, f in job.factors.items()}
        return cls(job.keys, list(job.stop_iters), np.asarray(job.finals),
                   job.best, np.asarray(job.hist), fac)


def checked_starts(sample: Sample, n_check: int, seed: int):
    others = [s for s in range(len(sample.keys)) if s != sample.best]
    rng = np.random.default_rng(derive(seed, "check"))
    k = min(max(n_check - 1, 0), len(others))
    return [sample.best] + sorted(int(s) for s in rng.choice(
        others, size=k, replace=False)) if k else [sample.best]


def compare(gen, cfg, seed, device, options, sample: Sample, n_check=1):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = load_reference(cfg)
    raw = gen.make_raw(cfg, seed, device)
    ref = reference.Reference(raw, dataclasses.asdict(options))
    out = {"f_gap": 0.0}
    for s in checked_starts(sample, n_check, seed):
        st0 = reference.init_state(raw, sample.keys[s], DTYPES[cfg["dtype"]],
                                   device)
        n = sample.stop_iters[s]
        hist, _, fac = ref.fit(st0, options.MaxOuterIters, at_least=n)
        f_ref = hist[n][0]
        out["f_gap"] = max(out["f_gap"],
                           float(abs(sample.finals[s] - f_ref) / abs(f_ref)))
        if s == sample.best:
            ref_hist = np.asarray([h[0] for h in hist[:n + 1]])
            gaps = np.abs(sample.hist[:n + 1] - ref_hist) / np.abs(ref_hist)
            out["f1_gap"] = float(gaps[1])
            out["fac_gap"] = max(
                float(torch.linalg.vector_norm(sample.fac[m] - F)
                      / torch.linalg.vector_norm(F)) for m, F in fac.items())
            out["f_gaps_by_iteration"] = gaps.tolist()
    return out
