"""Checkpoint and resume of the solver state (counterpart of
matlab_code_tpu/utils/checkpoint.py).

The reference's warm start (cmtf_AOADMM.m:44-45: `init` takes a whole G
struct, and the returned Fac carries every dual) is saving and restoring a
SolverState; fit(spec, data, load_state(path), options) resumes exactly.
The .npz layout is the JAX package's: one array "{field}.{i}" for every
slot that is not None, and "__meta__", the int64 length of every field in
_FIELDS order, so a state saved by either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.state import SolverState

_FIELDS = ("fac", "constraint_fac", "constraint_dual_fac", "coupling_fac",
           "coupling_dual_fac", "P", "DeltaB", "mu_DeltaB")


def save_state(path: str, state: SolverState) -> None:
    """Write a SolverState to an .npz file (None slots preserved; the
    arrays copied to the host as they are, dtype included)."""
    arrays = {}
    for f in _FIELDS:
        for i, x in enumerate(getattr(state, f)):
            if x is not None:
                arrays[f"{f}.{i}"] = x.detach().cpu().numpy()
    arrays["__meta__"] = np.array([len(getattr(state, f)) for f in _FIELDS],
                                  dtype=np.int64)
    np.savez(path, **arrays)


def load_state(path: str, device="cuda") -> SolverState:
    """Read a SolverState written by save_state (of either package), every
    array on `device` (the card unless asked for the CPU), bit for bit."""
    with np.load(path) as z:
        lens = z["__meta__"]
        kw = {f: tuple(torch.from_numpy(z[f"{f}.{i}"]).to(device)
                       if f"{f}.{i}" in z else None for i in range(int(n)))
              for f, n in zip(_FIELDS, lens)}
    return SolverState(**kw)
