"""Readings for a cell's limits (check.py's compared numbers), on the card
at the cell's own size: the program on each of --seeds, and the control,
the program with its TF32 path on (matmul_precision='tensorfloat32'), on
each of --control-seeds.  One job a seed (the window's first job: the same
keys, the same traffic), checked as a run checks its drawn job.  One
process for every seed; one JSON line a reading.

    python cardbench/calibrate.py --workload fusion.fit --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--out readings.jsonl]
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = str(ROOT)
    import torch
    from cardbench.harness import Cell, job_keys
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = Cell(args.workload)
    n = cell.traffic["n_starts"]
    out = open(args.out, "a") if args.out else None
    plan = [(int(s), "default") for s in args.seeds.split(",") if s] + [
        (int(s), "tensorfloat32") for s in args.control_seeds.split(",") if s]
    for seed, precision in plan:
        t = time.perf_counter()
        spec, data, options, init, _ = cell.problem(
            seed, "cuda", matmul_precision=precision)
        torch.cuda.synchronize()
        t_data = time.perf_counter() - t
        job = cell.run_job(spec, data, options, init, job_keys(seed, 0, n))
        torch.cuda.synchronize()
        del spec, data
        torch.cuda.empty_cache()
        t_job = time.perf_counter() - t
        t = time.perf_counter()
        numbers = cell.check(seed, "cuda", options, job)
        by_it = numbers.pop("f_gaps_by_iteration")
        line = {"workload": args.workload, "seed": seed,
                "precision": precision, **numbers,
                "f_gap_at": {t: by_it[t] for t in (1, 2, 3, 5, 10, 20, 50)
                             if t < len(by_it)},
                "stop_iters": job.stop_iters, "data_s": t_data,
                "job_s": t_job - t_data,
                "check_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
