"""The multi-process runtime (counterpart of
matlab_code_tpu/parallel/distributed.py), on torch.distributed.

Every process is one rank with one device: `initialize()` joins the
process group, `make_global_mesh()` makes the mesh over every rank, and
each rank runs the same entry point (fit(mesh=), cmtf_aoadmm(mesh=),
fit_multistart(mesh=)) on the same full problem, which every process builds
from its seed.  `globalize` / `globalize_tree` cut this rank's blocks of
the full value (parallel/sharding.device_put); `fetch` / `fetch_tree` give
every rank the full value back.  Launch n ranks on a host's cards with

    torchrun --nproc-per-node n script.py

where the script calls initialize() (torchrun's environment variables
fill its arguments) and make_global_mesh().  A rank's device is
cuda:{local rank mod the card count}, so two ranks share one card where
there is only one (NCCL refuses two ranks on one card: give those a gloo
group, backend='gloo').
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from matlab_code_tpu_torch.parallel.sharding import (
    Mesh, Shard, device_put, make_mesh)
from matlab_code_tpu_torch.problem import (
    Parafac2Tensor, ProblemData, SparseTensor)
from matlab_code_tpu_torch.state import FIELDS, SolverState


def local_rank() -> int:
    """This process's rank on its host: torchrun's LOCAL_RANK, else its
    global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else int(
        os.environ.get("RANK", 0))


def rank_device() -> torch.device:
    """cuda:{local rank mod the card count}, or the CPU without a card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """torch.distributed.init_process_group for this process.
    coordinator_address: 'host:port' (a TCP store the first rank serves),
    or an init URL ('tcp://...', 'file://...'); None: torchrun's
    MASTER_ADDR and MASTER_PORT ('env://').  num_processes and process_id
    default to WORLD_SIZE and RANK.  backend: 'nccl' where this rank's
    device is a card, 'gloo' on the CPU, unless named; an NCCL rank first
    takes its card as the current device."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    dist.destroy_process_group()


def make_global_mesh(device=None) -> Mesh:
    """The mesh over every rank of the default group, this rank's tensors
    on `device` (by default rank_device())."""
    return make_mesh(device=device)


def globalize(x, sharding: Shard):
    """This rank's block of the full value x (numpy or torch) on the mesh's
    device; every process must hold the same full x."""
    return None if x is None else sharding.block(x)


def globalize_tree(tree, shardings):
    """globalize over a ProblemData (with data_shardings: the blocks carry
    their layout, so fit runs its mesh path) or a SolverState (with
    state_shardings)."""
    return device_put(tree, shardings)


def fetch(x: torch.Tensor, sharding: Shard | None = None) -> torch.Tensor:
    """The full tensor on every rank from this rank's block cut by
    `sharding` (a tiled all_gather); a replicated value (no sharding, or
    axis None) is returned as it is."""
    if x is None or sharding is None:
        return x
    return sharding.gather(x)


def fetch_tree(tree, shardings=None):
    """fetch over laid-out ProblemData (its layout names the cuts), or over
    a SolverState cut by `shardings` (state_shardings: a PARAFAC2
    dataset's K-cut leaves); a SolverState without them is returned as it
    is (fit returns the full state)."""
    if isinstance(tree, SolverState):
        if shardings is None:
            return tree
        return SolverState(**{k: tuple(fetch(x, s) for x, s in zip(
            getattr(tree, k), getattr(shardings, k))) for k in FIELDS})
    if getattr(tree, "layout", None) is None:
        return tree
    lay = tree.layout

    def one(x, sh):
        if isinstance(x, SparseTensor):
            return SparseTensor(fetch(x.indices, sh.indices),
                                fetch(x.values, sh.values))
        if isinstance(x, Parafac2Tensor):
            return Parafac2Tensor(fetch(x.slices, sh.slices),
                                  fetch(x.mask, sh.mask))
        return fetch(x, sh)

    return ProblemData(
        objects=tuple(one(x, s) for x, s in zip(tree.objects, lay.objects)),
        miss=tuple(one(x, s) for x, s in zip(tree.miss, lay.miss)),
        coupl_trafo=tree.coupl_trafo, coupl_trafo2=tree.coupl_trafo2)


def replicas_agree(state: SolverState, mesh: Mesh) -> bool:
    """Whether every rank holds the same bits in every tensor of `state`:
    one all_gather of them all, flattened, compared byte for byte on every
    rank."""
    from matlab_code_tpu_torch.parallel.collectives import all_gather
    flat = [t.reshape(-1) for k in FIELDS for t in getattr(state, k)
            if t is not None]
    dt = flat[0].dtype
    mine = torch.cat([t.to(dt) for t in flat])[None]
    every = all_gather(mine, mesh).view(torch.uint8)
    return bool(torch.all(every == every[0:1]))
