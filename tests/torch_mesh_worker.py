"""One rank of the port's mesh tests (tests/test_torch_mesh_*.py): NOT a
pytest file, and it never imports jax or the JAX package.

Usage: torch_mesh_worker.py <job.pkl> <rank> <world> <init> <out.pkl>

init is an init URL (file://..., tcp://...) or 'env' (MASTER_ADDR,
MASTER_PORT, RANK and WORLD_SIZE set by the parent, as torchrun sets them).
The job (pickled by the test process from numpy arrays and the port's own
spec and option classes) is {'tasks': [(kind, name, payload), ...]}; each
task runs on the CPU in float64 over a gloo group of `world` ranks, and
this rank's results are pickled to out.pkl as {name: result}.  Results hold
numpy arrays only.  Prints MESHOK on success.
"""
import os
import pickle
import sys

job_path, rank, world, init, out_path = (sys.argv[1], int(sys.argv[2]),
                                         int(sys.argv[3]), sys.argv[4],
                                         sys.argv[5])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import matlab_code_tpu_torch as tp  # noqa: E402
from matlab_code_tpu_torch.convert import (  # noqa: E402
    data_from_numpy, state_from_numpy)
from matlab_code_tpu_torch.parallel import distributed  # noqa: E402
from matlab_code_tpu_torch.parallel.collectives import psum  # noqa: E402
from matlab_code_tpu_torch.parallel.shard_mttkrp import (  # noqa: E402
    build_sharded_mttkrps, make_sharded_mttkrp,
    make_sharded_mttkrp_pipelined, make_sharded_mttkrp_sparse)
from matlab_code_tpu_torch.parallel.sharding import (  # noqa: E402
    Shard, data_shardings, device_put, state_shardings)
from matlab_code_tpu_torch.state import FIELDS  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64


def npy(t):
    return None if t is None else t.detach().cpu().numpy()


def data_of(p):
    return data_from_numpy(p["objects"], p.get("coupl_trafo", ()),
                           p.get("coupl_trafo2", ()), p.get("miss", ()),
                           device=CPU, dtype=F64)


def summary(state, out, mesh=None):
    res = {"f": out.func_val_conv, "fc": out.func_coupl_conv,
           "frm": out.func_rel_missing, "f_rel_missing": out.f_rel_missing,
           "iters": out.OuterIterations, "inner": out.innerIters,
           "fac": [npy(t) for t in state.fac],
           "cpl": [npy(t) for t in state.coupling_fac]}
    if mesh is not None:
        res["counts"] = dict(mesh.counts)     # the fit's, before the check's
        res["agree"] = distributed.replicas_agree(state, mesh)
    return res


def task_fit(mesh, p):
    spec, opts = p["spec"], p["options"]
    data, state = data_of(p), state_from_numpy(p["state"], device=CPU)
    out = {}
    if p.get("plain", True):
        out["plain"] = summary(*tp.fit(spec, data, state, opts))
    # p["par2"]: the data laid out by hand (data_shardings(par2=...)), fit
    # taking the mesh from them; else fit(mesh=) lays them out
    par2 = p.get("par2")
    lay = data_shardings(spec, data, mesh, par2=par2 or "auto")[0]
    mesh.reset_stats()
    if par2 is None:
        st, o = tp.fit(spec, data, state, opts, mesh=mesh)
    else:
        st, o = tp.fit(spec, device_put(data, lay), state, opts)
    out["mesh"] = summary(st, o, mesh)
    out["layout"] = {q: getattr(getattr(s, "slices", s), "axis", None)
                     for q, s in enumerate(lay.objects)}
    out["impls"] = sorted(
        (k, f.__qualname__.split(".")[0]) for k, f in build_sharded_mttkrps(
            spec, data, mesh,
            pipelined=opts.mesh_pipelined_collectives).items())
    return out


def task_cmtf(mesh, p):
    spec, opts, init = p["spec"], p["options"], p["init_options"]
    data = data_of(p)
    _, st0, _, o0 = tp.cmtf_aoadmm(spec, data, opts, init_options=init,
                                   seed=p["seed"])
    mesh.reset_stats()
    _, st, _, o = tp.cmtf_aoadmm(spec, data, opts, init_options=init,
                                 seed=p["seed"], mesh=mesh)
    return {"plain": summary(st0, o0), "mesh": summary(st, o, mesh)}


def task_mttkrp(mesh, p):
    """Every sharded MTTKRP form on this rank's block, the whole result on
    every rank."""
    n, r = mesh.size, mesh.rank
    out = {}
    for label, (X, facs, shard_dim, target, form) in p["cases"].items():
        facs_t = [torch.from_numpy(f) for f in facs]
        if form == "sparse":
            idx, val, shape = X
            b = idx.shape[0] // n
            blk = tp.SparseTensor(torch.from_numpy(idx[r * b:(r + 1) * b]),
                                  torch.from_numpy(val[r * b:(r + 1) * b]))
            f = make_sharded_mttkrp_sparse(mesh, target, shape[target])
            got = f(blk, facs_t)
        else:
            blk = Shard(mesh, shard_dim).block(X)
            if form == "ring":
                f = make_sharded_mttkrp_pipelined(mesh, shard_dim, target)
            else:
                f = make_sharded_mttkrp(mesh, shard_dim, target)
            got = f(blk, facs_t)
            got2 = f(blk, facs_t)         # a second call on the same block
            assert torch.equal(got, got2)
        out[label] = npy(got)
    out["counts"] = dict(mesh.counts)
    return out


def task_multistart(mesh, p):
    """fit_multistart with keys, unsharded and over the mesh; the lanes
    from given init states (the JAX package's, one list for all starts),
    every start and this rank's share through best_over; a start count
    the mesh size does not divide."""
    from matlab_code_tpu_torch.models.multistart import _fit_lanes
    spec, data, opts, init = (p["spec"], data_of(p), p["options"],
                              p["init_options"])
    S = p["n_starts"]

    def keep(best):
        st, o, finals, stops = best
        return {"finals": finals, "stops": list(stops), "f": o.func_val_conv,
                "inner": o.innerIters, "fac": [npy(t) for t in st.fac]}

    res = {}
    for key, m in (("plain", None), ("mesh", mesh)):
        mesh.reset_stats()
        res[key] = keep(tp.fit_multistart(spec, data, opts, init, n_starts=S,
                                          keys=p["keys"], mesh=m))
        res[key]["counts"] = dict(mesh.counts)
    states = [state_from_numpy(s, device=CPU) for s in p["states"]]
    per = S // mesh.size
    res["lanes_mesh"] = keep(_fit_lanes(
        spec, data, states[mesh.rank * per:(mesh.rank + 1) * per],
        opts).best_over(mesh))
    try:
        tp.fit_multistart(spec, data, opts, init, n_starts=S + 1,
                          keys=list(p["keys"]) + [99], mesh=mesh)
        res["raised"] = None
    except ValueError as e:
        res["raised"] = str(e)
    return res


def task_runtime(mesh, p):
    """The runtime end to end: globalize, fetch (the data and the state,
    a PARAFAC2 dataset's K-cut leaves too), and a fit of globalized data
    and state without mesh= (the layout carries the mesh), as the JAX
    package's distributed worker runs it."""
    spec, opts = p["spec"], p["options"]
    data, state = data_of(p), state_from_numpy(p["state"], device=CPU)
    data_sh, sharded_modes = data_shardings(spec, data, mesh)
    state_sh = state_shardings(spec, state, mesh, sharded_modes)
    data_g = distributed.globalize_tree(data, data_sh)
    state_g = distributed.globalize_tree(state, state_sh)
    back = distributed.fetch_tree(data_g)
    back_st = distributed.fetch_tree(state_g, state_sh)
    leaves = lambda d: [t for X in d.objects for t in (
        (X.slices, X.mask) if hasattr(X, "slices") else (X,))] + [
        m for m in d.miss if m is not None]
    round_trip = all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                       leaves(data)))
    round_trip = round_trip and all(
        torch.equal(a, b) for k in FIELDS for a, b in zip(
            getattr(back_st, k), getattr(state, k)) if b is not None)
    arr = np.arange(4 * mesh.size * 3, dtype=np.float64).reshape(
        4 * mesh.size, 3)
    sh = Shard(mesh, 0)
    blk = distributed.globalize(arr, sh)
    round_trip = round_trip and bool(np.array_equal(
        npy(distributed.fetch(blk, sh)), arr)) and tuple(blk.shape) == (4, 3)
    st, o = tp.fit(spec, data_g, state_g, opts)
    res = summary(st, o, mesh)
    res["round_trip"] = round_trip
    res["sharded"] = sorted(sharded_modes)
    res["block_rows"] = {k: [None if t is None else t.shape[0]
                             for t in getattr(state_g, k)] for k in FIELDS}
    return res


TASKS = {"fit": task_fit, "cmtf": task_cmtf, "mttkrp": task_mttkrp,
         "multistart": task_multistart, "runtime": task_runtime}


def main():
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if init == "env":
        distributed.initialize(backend="gloo")
    else:
        distributed.initialize(init, num_processes=world, process_id=rank,
                               backend="gloo")
    mesh = distributed.make_global_mesh()
    assert (mesh.size, mesh.rank, mesh.device) == (world, rank, CPU), mesh
    results = {}
    for kind, name, payload in job["tasks"]:
        mesh.reset_stats()
        results[name] = TASKS[kind](mesh, payload)
    # one last collective: every rank got this far
    done = psum(torch.ones(1, dtype=F64), mesh)
    assert float(done) == world
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    distributed.shutdown()
    bad = sorted(k for k in sys.modules
                 if k == "jax" or k.startswith(("jax.", "matlab_code_tpu.")))
    assert not bad, bad
    print(f"rank {rank}: MESHOK", flush=True)


if __name__ == "__main__":
    main()
