"""The coupled EEM / NMR / LC-MS fusion of example script 15
(configs/fusion.json), drawn on the device from --seed.  A copy, with draws
from a torch generator and at the published mode sizes, of the port's
synthetic script-15 data (matlab_code_tpu_torch/utils/multistart_workload.
script15_problem, examples/script15_realdata.py):

  X_p = unit(unit(ktensor(Delta H_p, ...)) + noise unit(N_p))

three CP datasets sharing the sample mode through the script's type-4
selectors H_p (components x R_p, column j of H_p picking the j-th listed
component: EEM components 1-3, NMR 1-5, LC-MS 1-4 and 6), non-negative
uniform ground truth, Gaussian noise N_p.

make_raw gives the inputs that the program and the plain reference both
read; to_program builds the port's problem from them (the configuration's
constraint on every mode, type-4 coupling of the sample modes, random
initial factors with normalized columns)."""
from __future__ import annotations

import torch

from cardbench.generators.common import DTYPES, unit
from cardbench.seeds import derive

PARTS = ("eem", "nmr", "lcms")


def make_raw(cfg, seed: int, device):
    s = cfg["sizes"]
    dt = DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "data"))
    rand = lambda *shape: torch.rand(shape, generator=g, dtype=dt,
                                     device=device)
    S, RT = s["samples"], s["components"]
    H = []
    for p in PARTS:
        rows = torch.as_tensor(cfg["selectors"][p], device=device)
        h = torch.zeros((RT, len(rows)), dtype=dt, device=device)
        h[rows, torch.arange(len(rows), device=device)] = 1.0
        H.append(h)
    Delta = rand(S, RT)
    datasets, mode, modes_of = [], 0, []
    for p, h in zip(PARTS, H):
        shape, R = s[p], s[f"{p}_rank"]
        facs = [Delta @ h] + [rand(n, R) for n in shape[1:]]
        clean = (torch.einsum("ir,jr,kr->ijk", *facs) if len(shape) == 3
                 else facs[0] @ facs[1].T)
        noise = torch.randn(tuple(shape), generator=g, dtype=dt, device=device)
        X = unit(unit(clean) + s["noise"] * unit(noise)).contiguous()
        modes = tuple(range(mode, mode + len(shape)))
        modes_of.append(modes)
        mode += len(shape)
        datasets.append({"modes": modes, "rank": R, "weight": 1 / 3,
                         "dense": X})
    sizes = tuple(n for p in PARTS for n in s[p])
    return {"mode_sizes": sizes, "datasets": datasets,
            "coupling": {"type": 4, "modes": tuple(m[0] for m in modes_of),
                         "H": {m[0]: h for m, h in zip(modes_of, H)}}}


def to_program(raw, cfg):
    """(spec, data, options, init_options) of the port for `raw`."""
    from matlab_code_tpu_torch.options import AlgOptions, InitOptions
    from matlab_code_tpu_torch.problem import (
        ConstraintSpec, CouplingSpec, DatasetSpec, ProblemData, ProblemSpec)
    nb = len(raw["mode_sizes"])
    cpl = raw["coupling"]
    spec = ProblemSpec(
        mode_sizes=tuple(raw["mode_sizes"]),
        datasets=tuple(DatasetSpec(model="CP", modes=tuple(d["modes"]),
                                   rank=d["rank"], weight=d["weight"])
                       for d in raw["datasets"]),
        coupling=CouplingSpec(
            lin_coupled_modes=tuple(int(m in cpl["modes"]) for m in range(nb)),
            coupling_type=(cpl["type"],)),
        constraints=(ConstraintSpec(cfg["constraint"]),) * nb)
    data = ProblemData(objects=tuple(d["dense"] for d in raw["datasets"]),
                       coupl_trafo=tuple(cpl["H"].get(m) for m in range(nb)),
                       coupl_trafo2=(None,) * nb)
    init = InitOptions(distr=("rand",) * nb, normalize=True,
                       lambdas_init=tuple((1,) * d["rank"]
                                          for d in raw["datasets"]))
    return spec, data, AlgOptions(**cfg["options"]), init
