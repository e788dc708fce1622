"""Time the sequential-prox kernels (ops/prox_cuda: kernel A,
project_isotonic_cols; kernel B, prox_tv_cols; kernel C, t_smooth_cols)
through their wrappers, on the route each checkout's own plan takes (and
kernel C on both), the L2 flushed
before each run, on one CUDA card.  It serves to compare two checkouts in
one call, in turns (A, B, B, A):

    python3 matlab_code_tpu_torch/utils/time_prox_seq.py [--root DIR] [--label NAME]
        [--kernels A,B,C] [--c-stacks 512x256x32,...] [--phases]

Each (n, R) is timed in float32 on two kinds of column: "normal" (standard
normal draws) and "smooth" (a unimodal bump plus noise of 0.05, what a
fitted unimodal factor looks like, so few merges and many level sets or
segments).  Kernel A runs the non-negative unimodal projection; kernel B
the TV prox at lam 1e-3 (a jump almost every state on normal columns) and
lam 1.0 (long segments, a division most states).  The PAR2 stack (512,
256, 32) is timed the same way, and a ragged stack of 512 slices (J_k
drawn from 192..256, R 32, normal) through models/admm.prox_slicewise_
ragged with make_prox's unimodal and TV proxes, as the fit calls them.

--crossover (this checkout's routes): kernels A (unimodal and
non-decreasing) and B on K slices of 256 x 32, K from 1 to 132, the block
route (a block a column) against the lanes route in turns, to place the plan's
LANES_MIN_COLS.  --candidates: at the PAR2 stack, in turns, kernel B's
lanes route with its columns in shared memory or in a workspace, and the
lanes route of A and B against the block route.  --fit CONFIGS (comma-
separated utils/par2_surface configurations, e.g. ragged,unimodal): the
median ms an outer iteration of a 20-iteration float32 fit of each
through cmtf_aoadmm, host included (what the prox calls cost end to end;
the iteration is host-bound, so compare checkouts only in one call).

--kernels (default A,B,C) names the kernels timed.  Kernel C
(t_smooth_cols, the tPARAFAC2 prox at eta 1000, rho in [0.5, 1.5)) is
timed at the PAR2 stack (512, 256, 32), or at each K x J x R of
--c-stacks, in float32 and float64 on both of its routes, through the
checkout's private _t_smooth(X, rho, eta, route).
--phases (this checkout's kernel C only): the staged route's phases alone
on its own grid (the recurrence warps alone, the bit-exact floor; the
staging alone; the staging and the walks with the recurrence already
published) beside the whole kernel, the medians over blocks of the
kernel's clock stamps (each phase's span inside a launch, and the SM
clock), in both dtypes.

--root is the checkout whose matlab_code_tpu_torch is timed (by default
the one this file is in); its kernels build into that checkout.  Prints a
line a case (µs, ns a row) and one JSON line: the label, the card's name
and power limit (nvidia-smi) and the median milliseconds of each (kernel,
n, R, column, lam).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

SHAPES = ((512, 16), (256, 16), (4096, 20))
STACKS = ((512, 256, 32),)
RAGGED = (512, (192, 256), 32)      # K, J_k range, R
COLUMNS = ("normal", "smooth")
TV_LAMS = (1e-3, 1.0)
CROSS_KS = (1, 2, 4, 8, 16, 24, 33, 48, 66, 99, 132)
T_SMOOTH_ETA = 1000.0


def columns(kind: str, n: int, R: int, seed: int = 3, K: int = 0):
    """An (n, R) float64 numpy matrix of the named kind of column, or a
    (K, n, R) stack of them where K."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (K, n, R) if K else (n, R)
    if kind == "normal":
        return rng.standard_normal(shape)
    t = np.linspace(0.0, 1.0, n)[:, None]
    centre = rng.uniform(0.2, 0.8, shape[:-2] + (1, R))
    width = rng.uniform(0.05, 0.3, shape[:-2] + (1, R))
    return np.exp(-((t - centre) / width) ** 2) + 0.05 * rng.standard_normal(shape)


def in_turns(fa, fb, flush, runs, warmup):
    """Median ms of fa and fb, timed a, b, b, a."""
    from timing import time_ms
    a1 = time_ms(fa, flush, runs, warmup)
    b1 = time_ms(fb, flush, runs, warmup)
    b2 = time_ms(fb, flush, runs, warmup)
    a2 = time_ms(fa, flush, runs, warmup)
    return (a1 + a2) / 2, (b1 + b2) / 2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--candidates", action="store_true")
    ap.add_argument("--fit", default="")
    ap.add_argument("--kernels", default="A,B,C")
    ap.add_argument("--c-stacks", default="x".join(map(str, STACKS[0])))
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # the timer beside this file: --root may be a checkout that has none
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from timing import l2_flush, power_line, time_ms
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_prox_seq.py needs a CUDA card")
    import matlab_code_tpu_torch
    from matlab_code_tpu_torch.ops import prox_cuda
    pkg = os.path.dirname(os.path.abspath(matlab_code_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"matlab_code_tpu_torch came from {pkg}, not {root}")
    dev = torch.device("cuda")
    flush = l2_flush(dev)
    times = {}

    def run(key, fn, n):
        t = time_ms(fn, flush, args.runs, args.warmup)
        times[key] = t
        print(f"{args.label} kernel {key}: {t * 1e3:.1f} us "
              f"({t / n * 1e6:.1f} ns a row)", flush=True)

    for shape in (SHAPES + STACKS) if kernels & {"A", "B"} else ():
        n = shape[-2]
        K = shape[0] if len(shape) == 3 else 0
        name = "x".join(map(str, shape))
        for col in COLUMNS:
            X = torch.tensor(columns(col, n, shape[-1], K=K),
                             dtype=torch.float32, device=dev)
            if "A" in kernels:
                run(f"A {name} {col}",
                    lambda: prox_cuda.project_isotonic_cols(X, 2, True), n)
            for lam in TV_LAMS if "B" in kernels else ():
                lam_d = torch.tensor(lam, dtype=torch.float64, device=dev)
                run(f"B {name} {col} lam {lam}",
                    lambda lam_d=lam_d: prox_cuda.prox_tv_cols(X, lam_d), n)
    # the ragged stack as the fit's Bk step calls it
    import numpy as np
    from matlab_code_tpu_torch.models.admm import prox_slicewise_ragged
    from matlab_code_tpu_torch.ops import prox
    K, (lo, hi), R = RAGGED
    sizes = tuple(int(J) for J in
                  np.random.default_rng(5).integers(lo, hi + 1, K))
    Xr = columns("normal", hi, R, K=K)
    for k, J in enumerate(sizes):
        Xr[k, J:] = 0.0
    Xr = torch.tensor(Xr, dtype=torch.float32, device=dev)
    rho = torch.rand(K, generator=torch.Generator(device=dev).manual_seed(2),
                     device=dev, dtype=torch.float32) + 0.5
    for label, spec in (("A", prox.ConstraintSpec("unimodality", (True,))),
                        ("B", prox.ConstraintSpec("TV regularization",
                                                  (1e-3,)))):
        if label not in kernels:
            continue
        pf, _ = prox.make_prox(spec, hi)
        run(f"{label} ragged {K}x{lo}-{hi}x{R} normal ({len(set(sizes))} sizes)",
            lambda pf=pf: prox_slicewise_ragged(pf, Xr, rho, sizes), hi)
    if "C" in kernels:
        t_smooth(prox_cuda, dev, flush, args, times)
    if args.phases:
        t_smooth_phases(prox_cuda, dev, flush, args, times)
    if args.fit:
        fits(args, times)
    if args.crossover:
        crossover(prox_cuda, dev, flush, args, times)
    if args.candidates:
        candidates(prox_cuda, dev, flush, args, times)
    print(json.dumps({"label": args.label, "root": root,
                      "power": power_line(), "ms": times}))


def t_smooth_inputs(dev, dtype, shape=STACKS[0]):
    """A (K, n, R) stack of normal draws (the PAR2 stack by default) and
    rho in [0.5, 1.5) in dtype."""
    import torch
    K, n, R = shape
    X = torch.tensor(columns("normal", n, R, K=K), dtype=dtype, device=dev)
    rho = torch.rand(K, generator=torch.Generator(device=dev).manual_seed(2),
                     device=dev, dtype=dtype) + 0.5
    return X, rho


def t_smooth(prox_cuda, dev, flush, args, times):
    """Kernel C at each of --c-stacks on both routes in turns (staged,
    stream, stream, staged), float32 and float64."""
    import torch
    for name, dtype in ((n, d) for n in args.c_stacks.split(",")
                        for d in (torch.float32, torch.float64)):
        shape = tuple(int(v) for v in name.split("x"))
        X, rho = t_smooth_inputs(dev, dtype, shape)
        dt = str(dtype).split(".")[-1]
        planned = prox_cuda.plan_t_smooth(X.shape[0], X[0].numel(), dtype)[0]
        ts = in_turns(*(functools.partial(prox_cuda._t_smooth, X, rho,
                                          T_SMOOTH_ETA, route)
                        for route in (prox_cuda.STAGED, prox_cuda.STREAM)),
                      flush, args.runs, args.warmup)
        for route, t in zip((prox_cuda.STAGED, prox_cuda.STREAM), ts):
            times[f"C {name} {dt} {route}"] = t
            print(f"{args.label} kernel C {name} {dt} {route} route"
                  f"{' (planned)' if route == planned else ''}: "
                  f"{t * 1e3:.1f} us", flush=True)


def t_smooth_phases(prox_cuda, dev, flush, args, times):
    """Kernel C's staged route phase by phase on its own grid, float32 and
    float64."""
    import torch
    from timing import time_ms
    K = STACKS[0][0]
    for dtype in (torch.float32, torch.float64):
        X, rho = t_smooth_inputs(dev, dtype)
        dt = str(dtype).split(".")[-1]
        dbg = torch.zeros(4 * K, dtype=dtype, device=dev)
        out = torch.empty_like(X)
        full = prox_cuda._t_smooth(X, rho, T_SMOOTH_ETA, prox_cuda.STAGED)
        for label, mode in (("recurrence alone", prox_cuda.PHASE_RECURRENCE),
                            ("staging alone", prox_cuda.PHASE_STAGING),
                            ("walk, recurrence published",
                             prox_cuda.PHASE_WALK)):
            fn = functools.partial(prox_cuda._t_smooth_phase, mode, X, rho,
                                   T_SMOOTH_ETA, dbg, out)
            t = time_ms(fn, flush, args.runs, args.warmup)
            times[f"C phase {dt} {label}"] = t
            print(f"{args.label} kernel C phase {dt}: {label} {t * 1e3:.1f} us",
                  flush=True)
        if not torch.equal(out, full):
            raise SystemExit("kernel C: the walk phase gives other bits")
        for label, mode in (("whole kernel", prox_cuda.PHASE_ALL),
                            ("walk, recurrence published",
                             prox_cuda.PHASE_WALK)):
            spans = phase_stamps(prox_cuda, mode, X, rho, dbg, out)
            times[f"C stamps {dt} {label}"] = spans
            print(f"{args.label} kernel C stamps {dt} {label} (median over "
                  f"blocks, us at the clock the stamps give, "
                  f"{spans['clock_ghz']:.2f} GHz): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()
                              if k != "clock_ghz"), flush=True)
        t_all = time_ms(functools.partial(prox_cuda._t_smooth, X, rho,
                                          T_SMOOTH_ETA, prox_cuda.STAGED),
                        flush, args.runs, args.warmup)
        times[f"C phase {dt} whole kernel"] = t_all
        print(f"{args.label} kernel C phase {dt}: whole kernel {t_all * 1e3:.1f} us",
              flush=True)


def phase_stamps(prox_cuda, mode, X, rho, dbg, out):
    """The median over blocks of each span of one staged launch of kernel C
    at eta T_SMOOTH_ETA (after a warm-up run), from the kernel's clock
    stamps: the recurrence, the staging of the block's copies, the forward
    walk and the back substitution, in us at the SM clock the block's
    global-timer stamps give (clock_ghz), and the spread of the blocks'
    starts and the first start to the last end (global timer, us).  Also
    chip_smoke.py phase 11's."""
    import numpy as np
    import torch
    blocks = -(-X[0].numel() // prox_cuda.T_TILE)
    st = torch.zeros((blocks, prox_cuda.T_STAMPS), dtype=torch.int64,
                     device=X.device)
    for _ in range(2):
        prox_cuda._t_smooth_phase(mode, X, rho, T_SMOOTH_ETA, dbg, out,
                                  stamps=st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    ghz = float(np.median((s[:, 4] - s[:, 0]) / (s[:, 6] - s[:, 5])))
    span = {"clock_ghz": ghz}
    span["block start spread"] = float(s[:, 5].max() - s[:, 5].min()) / 1e3
    span["first start to last end"] = float(s[:, 6].max() - s[:, 5].min()) / 1e3
    for name, a, b in (("recurrence", 0, 1), ("staging", 0, 2),
                       ("start to forward end", 0, 3),
                       ("back substitution", 3, 4), ("whole block", 0, 4)):
        d = s[:, b] - s[:, a]
        span[name] = float(np.median(d)) / ghz / 1e3 if (d > 0).all() else 0.0
    return span


def fits(args, times):
    """Median ms an outer iteration of each named PARAFAC2 surface fit."""
    import numpy as np
    import torch
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm
    from matlab_code_tpu_torch.utils import par2_surface
    for config in args.fit.split(","):
        spec, data = par2_surface.build_problem(config, "cuda", torch.float32)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        state0 = init_coupled(spec, data,
                              par2_surface.surface_init_options(config),
                              generator=gen)
        opts = par2_surface.surface_options(config, par2_surface.N_ITERS,
                                            AbsFuncTol=0.0, OuterRelTol=0.0)
        torch.cuda.synchronize()
        out = cmtf_aoadmm(spec, data, opts, init=state0)[3]
        ms = float(np.median(np.diff(out.time_at_it))) * 1e3
        times[f"fit {config}"] = ms
        print(f"{args.label} fit {config}: {ms:.3f} ms an outer iteration "
              f"(median of {par2_surface.N_ITERS}, the options of "
              "chip_smoke.py phase 13)", flush=True)


def crossover(prox_cuda, dev, flush, args, times):
    """The block route against the lanes route on K slices of 256 x 32."""
    import torch
    n, R = 256, 32
    for K in CROSS_KS:
        X = torch.tensor(columns("normal", n, R, K=K), dtype=torch.float32,
                         device=dev)
        lam = torch.tensor(1e-3, dtype=torch.float64, device=dev)
        for name, block, lanes in (
                ("A unimodal", lambda: prox_cuda._isotonic(X, 2, True, "shared"),
                 lambda: prox_cuda._isotonic(X, 2, True, "lanes")),
                ("A non-decreasing",
                 lambda: prox_cuda._isotonic(X, 0, False, "shared"),
                 lambda: prox_cuda._isotonic(X, 0, False, "lanes")),
                ("B lam 0.001", lambda: prox_cuda._tv(X, lam, "shared"),
                 lambda: prox_cuda._tv(X, lam, "lanes"))):
            tb, tl = in_turns(block, lanes, flush, args.runs, args.warmup)
            times[f"crossover {name} K {K} block"] = tb
            times[f"crossover {name} K {K} lanes"] = tl
            print(f"{args.label} crossover {name} {K}x{n}x{R} ({K * R} columns):"
                  f" block {tb * 1e3:.1f} us, lanes {tl * 1e3:.1f} us, "
                  f"lanes/block {tl / tb:.2f}", flush=True)


def candidates(prox_cuda, dev, flush, args, times):
    """At the PAR2 stack, in turns: kernel B's lanes route with its columns
    staged in shared memory or in a device-memory workspace, and the lanes
    route of A and B against the block route."""
    import torch
    K, n, R = STACKS[0]
    for col in COLUMNS:
        X = torch.tensor(columns(col, n, R, K=K), dtype=torch.float32,
                         device=dev)
        lam = torch.tensor(1e-3, dtype=torch.float64, device=dev)
        pairs = (("B lam 0.001: shared | workspace",
                  lambda: prox_cuda._tv(X, lam, "lanes", in_shared=True),
                  lambda: prox_cuda._tv(X, lam, "lanes", in_shared=False)),
                 ("A unimodal nonneg: lanes | block (shared route)",
                  lambda: prox_cuda._isotonic(X, 2, True, "lanes"),
                  lambda: prox_cuda._isotonic(X, 2, True, "shared")),
                 ("A non-decreasing: lanes | block (shared route)",
                  lambda: prox_cuda._isotonic(X, 0, False, "lanes"),
                  lambda: prox_cuda._isotonic(X, 0, False, "shared")),
                 ("B lam 0.001: lanes | block (shared route)",
                  lambda: prox_cuda._tv(X, lam, "lanes"),
                  lambda: prox_cuda._tv(X, lam, "shared")))
        for name, fa, fb in pairs:
            if not torch.equal(fa(), fb()):
                raise SystemExit(f"candidates {name}: the two give other bits")
            ta, tb = in_turns(fa, fb, flush, args.runs, args.warmup)
            times[f"candidates {name} {col}"] = [ta, tb]
            print(f"{args.label} candidates {name}, {K}x{n}x{R} {col}: "
                  f"{ta * 1e3:.1f} us | {tb * 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    main()
