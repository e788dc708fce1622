"""Time fit's own path on one CUDA card: the flagship (utils/flagship.py)
and the KL workload (utils/kl_workload.py) through fit, with their host
reads and kernel launches an iteration.  It serves to compare two
checkouts in one call, in turns (A, B, B, A):

    python3 matlab_code_tpu_torch/utils/time_fit.py [--root DIR] [--label NAME]

--root is the checkout whose matlab_code_tpu_torch is timed (by default
the one this file is in); its kernels build into that checkout.  Each fit
runs once for a few iterations before it is timed.  Prints one JSON line:
the label, the card's name and power limit (nvidia-smi), and for each
workload the median ms an iteration (the fit's own time_at_it), the host
reads (models/admm.to_host) and the launches of mttkrp3 and kernel D an
iteration, and the final f_tensors (the same bits from two checkouts whose
arithmetic is the same).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--flagship-iters", type=int, default=100)
    ap.add_argument("--kl-iters", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # the timer beside this file: --root may be a checkout that has none
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from timing import power_line
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_fit.py needs a CUDA card")
    import matlab_code_tpu_torch as tp
    pkg = os.path.dirname(os.path.abspath(tp.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"matlab_code_tpu_torch came from {pkg}, not {root}")
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_cuda
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.utils import flagship, kl_workload

    def timed(spec, data, state, options, warm):
        tp.fit(spec, data, state, warm)
        to_host.calls = mttkrp3.launches = loss_fg_cuda.launches = 0
        _, out = tp.fit(spec, data, state, options)
        n = out.OuterIterations
        return {"ms": float(np.median(np.diff(out.time_at_it)) * 1e3),
                "reads": to_host.calls / n, "mttkrp3": mttkrp3.launches / n,
                "kernel_D": loss_fg_cuda.launches / n,
                "f_tensors": out.f_tensors}

    dev = torch.device("cuda")
    res = {"label": args.label, "device": power_line()}
    spec, data = flagship.build_problem(dev, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = tp.init_coupled(spec, data, flagship.flagship_init_options(),
                            generator=gen)
    res["flagship"] = timed(
        spec, data, state,
        flagship.flagship_options(args.flagship_iters, AbsFuncTol=0.0,
                                  OuterRelTol=0.0),
        flagship.flagship_options(3, AbsFuncTol=0.0, OuterRelTol=0.0))
    spec, data, state, _ = kl_workload.build_problem(dev, torch.float32)
    res["kl"] = timed(
        spec, data, state,
        kl_workload.kl_options(args.kl_iters, AbsFuncTol=0.0, OuterRelTol=0.0),
        kl_workload.kl_options(1, AbsFuncTol=0.0, OuterRelTol=0.0))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
