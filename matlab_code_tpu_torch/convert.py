"""Bridge between the JAX package and the port: specs, data and solver
states cross as plain attributes and numpy arrays, so this module (like the
whole port) never imports jax.

  spec_from_reference(obj)  a JAX-package ProblemSpec -> the port's ProblemSpec
  options_from_reference(obj)  a JAX-package AlgOptions -> the port's AlgOptions
  data_from_numpy(...)      numpy arrays (and COO tensors) -> the port's
                            ProblemData, on the card unless `device` says
  state_from_numpy(fields)  a SolverState's arrays -> the port's SolverState,
                            on the card unless `device` says
  state_to_numpy(state)     the port's SolverState -> {field: tuple of arrays}
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, LbfgsbOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, Parafac2Tensor, ProblemData,
    ProblemSpec, SparseTensor)
from matlab_code_tpu_torch.state import FIELDS, SolverState


def constraint_from_reference(c) -> ConstraintSpec | None:
    """Copy a ConstraintSpec of the JAX package: every kind, its params,
    its matrix as a numpy array.  A 'custom' spec raises ValueError: its
    fns are jnp code, which the port cannot call."""
    if c is None:
        return None
    if c.kind == "custom":
        raise ValueError(
            "a 'custom' constraint of the JAX package carries jnp functions; "
            "build the port's ConstraintSpec('custom', fns=...) with torch "
            "functions instead")
    matrix = None if c.matrix is None else np.asarray(c.matrix)
    return ConstraintSpec(c.kind, tuple(c.params), matrix)


def spec_from_reference(obj) -> ProblemSpec:
    """Copy a ProblemSpec of the JAX package (read by attribute) into the
    port's ProblemSpec."""
    constraints = tuple(constraint_from_reference(c) for c in obj.constraints)
    return ProblemSpec(
        mode_sizes=tuple(obj.mode_sizes),
        datasets=tuple(DatasetSpec(model=d.model, modes=tuple(d.modes),
                                   rank=d.rank, loss=d.loss,
                                   loss_param=d.loss_param, weight=d.weight)
                       for d in obj.datasets),
        coupling=CouplingSpec(tuple(obj.coupling.lin_coupled_modes),
                              tuple(obj.coupling.coupling_type)),
        constraints=constraints,
        ridge=None if obj.ridge is None else tuple(obj.ridge))


def options_from_reference(obj) -> AlgOptions:
    """Copy an AlgOptions of the JAX package (read by attribute, field by
    field) into the port's AlgOptions."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(AlgOptions)}
    kw["lbfgsb"] = LbfgsbOptions(**{f.name: getattr(obj.lbfgsb, f.name)
                                    for f in dataclasses.fields(LbfgsbOptions)})
    return AlgOptions(**kw)


def _tensor(a, device, dtype):
    if a is None:
        return None
    a = np.asarray(a)   # may be a read-only view: torch.tensor copies it
    if a.dtype == bool:
        return torch.tensor(a, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _object(a, device, dtype):
    """A dense array, a PARAFAC2 tensor read by its attributes `slices` and
    `mask` (the JAX package's Parafac2Tensor), or a COO tensor read by its
    attributes `indices` and `values` (the JAX package's SparseTensor: its
    plans are the TPU layout and are not carried across)."""
    if hasattr(a, "slices") and hasattr(a, "mask"):
        return Parafac2Tensor(_tensor(a.slices, device, dtype),
                              torch.tensor(np.asarray(a.mask), dtype=torch.bool,
                                           device=device))
    if hasattr(a, "indices") and hasattr(a, "values"):
        return SparseTensor(
            torch.tensor(np.asarray(a.indices), dtype=torch.int32,
                         device=device),
            _tensor(a.values, device, dtype))
    return _tensor(a, device, dtype)


def data_from_numpy(objects, coupl_trafo=(), coupl_trafo2=(), miss=(),
                    device="cuda", dtype=torch.float64) -> ProblemData:
    """Build the port's ProblemData from arrays (anything np.asarray takes,
    including the JAX package's ProblemData fields, SparseTensors and
    Parafac2Tensors)."""
    conv = lambda seq: tuple(_tensor(a, device, dtype) for a in seq)
    return ProblemData(objects=tuple(_object(a, device, dtype)
                                     for a in objects),
                       miss=conv(miss), coupl_trafo=conv(coupl_trafo),
                       coupl_trafo2=conv(coupl_trafo2))


def state_from_numpy(fields, device="cuda", dtype=torch.float64) -> SolverState:
    """The port's SolverState from a mapping {field: tuple of arrays or
    None}, or from any object with those attributes (a JAX-package
    SolverState, whose arrays np.asarray reads), PARAFAC2's P, DeltaB and
    mu_DeltaB included."""
    get = fields.get if isinstance(fields, dict) else (
        lambda k: getattr(fields, k))
    return SolverState(**{k: tuple(_tensor(a, device, dtype) for a in get(k))
                          for k in FIELDS})


def state_to_numpy(state: SolverState) -> dict:
    """{field: tuple of numpy arrays or None} of a port SolverState."""
    return {k: tuple(None if t is None else t.detach().cpu().numpy()
                     for t in getattr(state, k))
            for k in FIELDS}
