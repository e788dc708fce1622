"""The start axis of fit_multistart (models/multistart.py): what the
port's code needs where it runs one start's arithmetic under
torch.func.vmap over the starts.

Inside that vmap a tensor that carries the start axis is a functorch
batched tensor (on_start_axis).  Plain torch ops batch by themselves; three
things do not, and each is routed where it happens:
  * a read of a device flag that steers a host loop (the inner ADMM loops,
    models/admm.run_inner; the lanes L-BFGS-B, ops/lbfgsb.py): any_lane
    reads whether any start is still stepping, one read however many
    starts there are;
  * a hand-written kernel, which takes raw pointers: ops/tensor.mttkrp
    (one mttkrp3 call with the starts' columns side by side) and the
    sequential proxes of ops/isotonic.py, ops/tv.py and
    ops/prox.t_smoothness_prox (the start axis folded into the slice
    axis, or one launch a start) are custom operators whose batching rule
    (torch.library.register_vmap) calls the kernel, or the plain version
    on the CPU, on the whole start axis;
  * a start that stopped keeps its values (keep; the inner loops' carries
    and the lanes L-BFGS-B's): the JAX while_loop's semantics under vmap.
Nothing here runs, and nothing is routed, outside that vmap: fit's path
is unchanged.
"""
from __future__ import annotations

import torch

from matlab_code_tpu_torch.state import SolverState, fields_of


def on_start_axis(*ts) -> bool:
    """True where any of the tensors carries the start axis (is a
    functorch batched tensor inside fit_multistart's vmap)."""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_batchedtensor(t) for t in ts)


@torch.library.custom_op("matlab_code_tpu_torch::any_lane", mutates_args=())
def any_lane(flags: torch.Tensor) -> torch.Tensor:
    """Whether each flag holds for any start: bool flags of the same shape
    WITHOUT the start axis, so a host loop under the vmap can read them
    (to_host), several flags in one read.  Off the start axis (one start)
    they are the flags themselves."""
    return flags.clone()


@torch.library.register_vmap("matlab_code_tpu_torch::any_lane")
def _any_lane_vmap(info, in_dims, flags):
    return flags.any(dim=in_dims[0]), None


def to_front(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """An operand of a batching rule with the start axis first: moved there
    (dim an int) or broadcast along it (dim None, the same for every
    start)."""
    if dim is None:
        return x.expand(size, *x.shape)
    return x.movedim(dim, 0)


def keep(active, new, old):
    """new where the start is still active, old where it has stopped,
    leaf by leaf over tensors, tuples and SolverStates.  A leaf that the
    step did not replace (the same tensor object) stays as it is, so no
    select is paid for it and an identity-keyed cache (models/updates.py)
    still sees the same object."""
    if new is old or not isinstance(new, (torch.Tensor, tuple,
                                          SolverState)):
        return new
    if isinstance(new, SolverState):
        return SolverState(*(keep(active, a, b) for a, b in
                             zip(fields_of(new), fields_of(old))))
    if isinstance(new, tuple):
        return tuple(keep(active, a, b) for a, b in zip(new, old))
    if not isinstance(old, torch.Tensor):
        return new
    return torch.where(active, new, old)
