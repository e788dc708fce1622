"""Solver state: the reference's `G` / `Fac` struct (counterpart of
matlab_code_tpu/state.py).

Every field is a tuple indexed by mode / coupling id / dataset, holding
torch tensors or None.  Tensors in a state are never updated in place:
every update builds a new tensor and a new tuple (tuple_set), so a cache
keyed by a factor's identity never sees a stale value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass
class SolverState:
    fac: tuple
    constraint_fac: tuple
    constraint_dual_fac: tuple
    coupling_fac: tuple
    coupling_dual_fac: tuple
    P: tuple
    DeltaB: tuple
    mu_DeltaB: tuple

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(nb_modes: int, n_couplings: int, n_datasets: int) -> "SolverState":
        none = lambda n: tuple(None for _ in range(n))
        return SolverState(
            fac=none(nb_modes), constraint_fac=none(nb_modes),
            constraint_dual_fac=none(nb_modes),
            coupling_fac=none(n_couplings), coupling_dual_fac=none(nb_modes),
            P=none(n_datasets), DeltaB=none(n_datasets),
            mu_DeltaB=none(n_datasets))


FIELDS = tuple(f.name for f in dataclasses.fields(SolverState))


def fields_of(state: SolverState) -> tuple:
    """The state's fields in FIELDS order: SolverState(*fields_of(s)) is s."""
    return tuple(getattr(state, f) for f in FIELDS)


def tuple_set(t: tuple, i: int, v: Any) -> tuple:
    return t[:i] + (v,) + t[i + 1:]
