"""The collectives a mesh's reductions run (the port's stand-ins for
shard_map's psum, tiled all_gather and ppermute), over the mesh's
torch.distributed group.

The group's backend alone picks the transport, and no error switches it:
  * on an NCCL group the tensors stay on the card;
  * on a gloo group every collective takes host tensors: a card tensor is
    copied to the host before the call and the result back after it,
    explicitly (gloo takes card tensors in some collectives only; staging
    all of them keeps one rule).  On the CPU the copies are no-ops.
Each call counts itself in mesh.counts[name] and the host-clock seconds of
its copies (the wait for the card included) in mesh.stage_seconds[name].

psum is the backend's all_reduce: NCCL's and gloo's give every rank the
same bits (each part of the sum is reduced once and sent to every rank),
so the state stays the same on every rank (parallel/sharding.py); the
mesh tests and chip_smoke.py check that every rank ends a fit with the
same bits.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from matlab_code_tpu_torch.parallel.sharding import Mesh


def _staged(mesh: Mesh) -> bool:
    if mesh.group is None and mesh.backend is None:
        raise ValueError("this mesh has no process group: it lays data out "
                         "and runs no collective (sharding.make_mesh)")
    return mesh.backend == "gloo"


def _to_wire(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if _staged(mesh) and t.device.type == "cuda":
        t0 = time.perf_counter()
        t = t.cpu()
        mesh.stage_seconds[name] += time.perf_counter() - t0
    return t


def _from_wire(mesh: Mesh, name: str, t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        t0 = time.perf_counter()
        t = t.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mesh.stage_seconds[name] += time.perf_counter() - t0
    return t


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's t (same shape on each), on every rank, by
    all_reduce (t itself is left as it is)."""
    mesh.counts["psum"] += 1
    x = _to_wire(mesh, "psum", t)
    if x is t:
        x = t.clone()
    dist.all_reduce(x, group=mesh.group)
    return _from_wire(mesh, "psum", x, t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """Every rank's t concatenated along `axis` in rank order (a tiled
    all_gather), on every rank."""
    mesh.counts["all_gather"] += 1
    x = _to_wire(mesh, "all_gather", t)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts, dim=axis)
    return _from_wire(mesh, "all_gather", out, t.device)


class _Exchange:
    """A ring step in flight: wait() returns the tensor the previous rank
    sent, on this rank's device (the tensor sent is held until then)."""

    def __init__(self, mesh, reqs, sent, buf, device):
        self.mesh, self.reqs, self.sent, self.buf = mesh, reqs, sent, buf
        self.device = device

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        return _from_wire(self.mesh, "ring", self.buf, self.device)


def ring_send(t: torch.Tensor, mesh: Mesh) -> _Exchange:
    """Start one ring step (shard_map's ppermute to rank + 1): send t to the
    next rank and receive the previous rank's tensor of t's shape, by
    batch_isend_irecv; the caller computes meanwhile and then waits."""
    mesh.counts["ring"] += 1
    x = _to_wire(mesh, "ring", t)
    buf = torch.empty_like(x)
    nxt = mesh.ranks[(mesh.rank + 1) % mesh.size]
    prv = mesh.ranks[(mesh.rank - 1) % mesh.size]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, nxt, group=mesh.group),
        dist.P2POp(dist.irecv, buf, prv, group=mesh.group)])
    return _Exchange(mesh, reqs, x, buf, t.device)


def gather_object(obj, mesh: Mesh) -> list:
    """Every rank's picklable obj, in rank order, on every rank (tensors in
    it should lie on the host)."""
    _staged(mesh)
    mesh.counts["gather_object"] += 1
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
