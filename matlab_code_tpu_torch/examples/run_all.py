"""Run every example script of the port in sequence (counterpart of
examples/run_all.py):

    python -m matlab_code_tpu_torch.examples.run_all [--small|--full]
        [--replay] [--device cuda|cpu] [--max-iters N] [--plots[=DIR]]

--small (default): the scripts' reduced sizes; --full: the reference-scale
configurations.  --replay: the 13 reference-seeded replays (data and init
on the MATLAB twister stream, the reference's options) in place of
build()'s configurations.  --device: the card (default) or the CPU; without
a card the runner refuses unless --device cpu is given.  --max-iters caps
every fit's MaxOuterIters.  --plots draws each build() run's convergence
figure (needs matplotlib).  Prints each script's summary and seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import time

SCRIPTS = [
    "script01_cp_par2_nonneg", "script01a_cp_par2_smooth_l2ball",
    "script02_matrix_par2_nonneg", "script03_matrix_cp_partialcoupling",
    "script04_irregular_par2", "script05_cp_cp_doublesampling_simplex",
    "script06_three_datasets", "script07_matrix_cp_kl",
    "script08_regular_par2_nonneg", "script09_par2_unimodality",
    "script10_cp_tv", "script11_tparafac2", "script12_cp_par2_em",
    "script13_cp_cp_type5", "script14_cp_par2_couplC", "script15_realdata",
]
# the scripts with a reference-seeded replay (run_reference)
REPLAYS = [n for n in SCRIPTS if not n.startswith(
    ("script07", "script11", "script15"))]


def module(name):
    return importlib.import_module(f"matlab_code_tpu_torch.examples.{name}")


def run_script(name, small=True, device=None, dtype=None, max_iters=None,
               replay=False, save_plots=None, verbose=True):
    """One script's run dict: its reference-seeded replay (replay=True), its
    best of 20 starts (3 where small) for script 15, else run() of its
    build(small).  max_iters caps MaxOuterIters."""
    from matlab_code_tpu_torch.examples.common import run
    mod = module(name)
    cap = {} if max_iters is None else {"MaxOuterIters": max_iters}
    if replay:
        return mod.run_reference(verbose=verbose, device=device, dtype=dtype,
                                 **cap)
    if name == "script15_realdata":
        return mod.main(n_starts=3 if small else 20, small=small,
                        device=device, dtype=dtype, max_iters=max_iters,
                        verbose=verbose)
    cfg = mod.build(small=small)
    cfg["opts"] = dataclasses.replace(cfg["opts"], **cap)
    return run(**cfg, device=device, dtype=dtype, verbose=verbose,
               save_plots=save_plots)


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--small", action="store_true", default=True)
    size.add_argument("--full", action="store_true")
    ap.add_argument("--replay", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--plots", nargs="?", const="docs/plots", default=None,
                    metavar="DIR")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_all: no CUDA card here "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    if args.plots:
        try:       # fail before any fit runs
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("run_all: --plots draws with matplotlib, which "
                             "is not installed here") from None
    small = not args.full
    names = REPLAYS if args.replay else SCRIPTS
    t_all = time.time()
    for name in names:
        kind = "replay" if args.replay else ("small" if small else "full")
        print(f"=== {name} ({kind}, {args.device}) ===", flush=True)
        t0 = time.time()
        save = (f"{args.plots}/{name}.png"
                if args.plots and not args.replay
                and name != "script15_realdata" else None)
        run_script(name, small=small, device=args.device,
                   max_iters=args.max_iters, replay=args.replay,
                   save_plots=save)
        print(f"    [{time.time() - t0:.1f}s]", flush=True)
    print(f"total: {time.time() - t_all:.1f}s")


if __name__ == "__main__":
    main()
