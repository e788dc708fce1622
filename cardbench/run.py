"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data on the card from the seed, the kernels' libraries, one whole
job of the cell's shapes), then jobs back to back for
--seconds, then one job of the window fitted again by the plain reference
(cardbench/reference/) to decide `correct`.  The last line of standard
output is the result as one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error.  A run needs an NVIDIA
card and fails without one.  Caches of the program's compilers live in
.cardbench_cache/ at the root of the checkout; the port builds its kernels
into matlab_code_tpu_torch/_build/.
"""
import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".cardbench_cache"


def current_cpu() -> int:
    """The core this process last ran on, where the kernel's scheduler
    placed it (field 39 of /proc/self/stat), if the process may use it;
    else the first core it may use."""
    allowed = os.sched_getaffinity(0)
    try:
        with open("/proc/self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        cpu = -1
    return cpu if cpu in allowed else min(allowed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # the host loop is the pace of most cells: one core for this process
    # and the threads it starts, the one it runs on now
    os.sched_setaffinity(0, {current_cpu()})
    # the checkout's root, not this folder: the benchmark is the package
    # cardbench, and its module names must not shadow the standard library
    sys.path[0] = str(ROOT)

    import torch
    from cardbench.harness import find_cell, run_cell
    _, cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      T_PROCESS0)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
