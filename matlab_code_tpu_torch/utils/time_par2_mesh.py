"""Time the PARAFAC2 K-cut layout against PARAFAC2 replicated, over n
ranks, one card a rank over NCCL: the PAR2 K=512 workload
(utils/par2_workload.py) and configurations of the PARAFAC2 surface
(utils/par2_surface.py) through fit, the data laid out by hand both ways
(parallel/sharding.data_shardings, par2='cut' and par2='replicated'), in
turns (cut, replicated, replicated, cut) after one short warm fit of
each:

    python3 matlab_code_tpu_torch/utils/time_par2_mesh.py [--ranks N]
        [--iters N] [--dtype float32|float64] [--configs par2,tparafac2,...]
        [--K K] [--cpu]

--ranks defaults to every visible card; --cpu runs the ranks on the CPU
over gloo (a rehearsal at a small --K).  Each rank builds the full problem
from its seed and draws the same init (init_coupled, seed 1) before the
counts are set to 0.  Rank 0 prints one JSON line: the card's name and
power limit (nvidia-smi), and for each configuration and layout the
slowest rank's median ms an iteration in each turn, rank 0's collectives
an iteration and kernel launches in the fit, whether the ranks' states
agree, and the largest relative gap of the f_tensors stream between the
two layouts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import socket
import sys

CONFIGS = ("par2", "tparafac2", "ragged", "tv", "coupled")
LAYOUTS = ("cut", "replicated")
TURNS = ("cut", "replicated", "replicated", "cut")


def _problem(config, dev, dt, K, iters):
    """(spec, data, options, init options) of a configuration: 'par2' the
    PAR2 workload, any other name a PARAFAC2 surface configuration."""
    from matlab_code_tpu_torch.utils import par2_surface, par2_workload
    stop = dict(AbsFuncTol=0.0, OuterRelTol=0.0)
    if config == "par2":
        spec, data = par2_workload.build_problem(dev, dt, K=K)
        return (spec, data, par2_workload.par2_options(iters, **stop),
                par2_workload.par2_init_options())
    spec, data = par2_surface.build_problem(config, dev, dt, K)
    return (spec, data, par2_surface.surface_options(config, iters, **stop),
            par2_surface.surface_init_options(config))


def _rank(rank, world, url, backend, args):
    """One rank: every configuration, both layouts, in turns.  Returns
    rank 0's rows (None on the other ranks)."""
    sys.path.insert(0, args["root"])
    import numpy as np
    import torch
    import torch.distributed as dist
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import fit
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.prox_cuda import (
        project_isotonic_cols, prox_tv_cols, t_smooth_cols)
    from matlab_code_tpu_torch.parallel import distributed, sharding
    counters = {"mttkrp3": mttkrp3, "A": project_isotonic_cols,
                "B": prox_tv_cols, "C": t_smooth_cols}
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    distributed.initialize(url, world, rank, backend=backend)
    try:
        mesh = distributed.make_global_mesh(
            torch.device("cpu") if backend == "gloo" else None)
        dt = getattr(torch, args["dtype"])
        sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
                else lambda: None)
        rows = []
        for config in args["configs"]:
            spec, data, opts, init_opts = _problem(
                config, mesh.device, dt, args["K"], args["iters"])
            warm = dataclasses.replace(opts, MaxOuterIters=2)
            init = init_coupled(spec, data, init_opts, seed=1)
            laid = {lay: sharding.device_put(data, sharding.data_shardings(
                spec, data, mesh, par2=lay)[0])
                for lay in LAYOUTS}
            for lay in LAYOUTS:
                fit(spec, laid[lay], init, warm)
            ms = {lay: [] for lay in LAYOUTS}
            seen = {}
            for lay in TURNS:
                sync()
                dist.barrier()
                for fn in counters.values():
                    fn.launches = 0
                mesh.reset_stats()
                state, out = fit(spec, laid[lay], init, opts)
                sync()
                mine = float(np.median(np.diff(out.time_at_it)) * 1e3)
                every = [None] * world
                dist.all_gather_object(every, mine)
                ms[lay].append(max(every))
                n = out.OuterIterations
                seen[lay] = {
                    "collectives_per_iter": {k: v / n for k, v in
                                             mesh.counts.items() if v},
                    "launches": {k: fn.launches for k, fn in counters.items()
                                 if fn.launches},
                    "agree": distributed.replicas_agree(state, mesh),
                    "f": np.asarray(out.func_val_conv)}
            f_cut, f_rep = seen["cut"].pop("f"), seen["replicated"].pop("f")
            gap = float(np.max(np.abs(f_cut - f_rep)
                               / np.maximum(np.abs(f_rep), 1e-300)))
            for lay in LAYOUTS:
                rows.append(dict(config=config, layout=lay, ms=ms[lay],
                                 f_tensors_gap=gap, **seen[lay]))
            del data, laid, init
        return rows if rank == 0 else None
    finally:
        distributed.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--K", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    from matlab_code_tpu_torch.utils.timing import power_line
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("time_par2_mesh.py needs CUDA cards (or --cpu)")
    world = args.ranks or (2 if args.cpu else torch.cuda.device_count())
    if not args.cpu and world > torch.cuda.device_count():
        raise SystemExit(f"{world} ranks, {torch.cuda.device_count()} cards")
    s = socket.socket()
    s.bind(("localhost", 0))
    url = f"tcp://localhost:{s.getsockname()[1]}"
    s.close()
    job = dict(root=root, dtype=args.dtype, K=args.K, iters=args.iters,
               configs=[c for c in args.configs.split(",") if c])
    backend = "gloo" if args.cpu else "nccl"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(world) as pool:
        res = [pool.apply_async(_rank, (r, world, url, backend, job))
               for r in range(world)]
        rows = [r.get() for r in res][0]
    print(json.dumps({
        "ranks": world, "backend": backend, "dtype": args.dtype, "K": args.K,
        "iters": args.iters,
        "device": "cpu" if args.cpu else torch.cuda.get_device_name(0),
        "power": None if args.cpu else power_line(), "rows": rows}))


if __name__ == "__main__":
    main()
