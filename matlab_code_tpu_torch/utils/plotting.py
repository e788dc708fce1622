"""Convergence-figure helper, the reference scripts' plotting block
(counterpart of matlab_code_tpu/utils/plotting.py).

Every reference example script renders the same three-panel figure after
the fit (example_script1_CP_PAR2_nonneg.m:154-189): the objective streams
on a semilog axis vs iterations, the same streams vs wall time
(out.time_at_it), and the per-mode inner-iteration counts.  This module
reproduces that figure from any FitOutput.  matplotlib is imported only
when a figure is drawn, so nothing else of the port needs it.
"""
from __future__ import annotations

import numpy as np


def plot_convergence(out, path=None, title="convergence AO-ADMM",
                     mode_names=None, show=False):
    """Render the reference's convergence figure from a FitOutput.

    Panel 1 (example_script1:156-166): semilogy of func_val_conv,
    func_coupl_conv (dashed), func_constr_conv (dotted) and, when the
    problem has PARAFAC2 datasets / missing data, func_PAR2_coupl and
    func_rel_missing, vs outer iteration.
    Panel 2 (:168-178): the same streams vs out.time_at_it seconds.
    Panel 3 (:180-188): per-mode inner-iteration counts per outer
    iteration, one marker series per mode.

    path: write a PNG there (parent dirs created); show: plt.show().
    Returns the matplotlib Figure.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plot_convergence draws with matplotlib, which is not "
            "installed here; run without --plots / save_plots") from e
    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    it = np.arange(len(np.asarray(out.func_val_conv)))
    streams = [("function value", np.asarray(out.func_val_conv), "-"),
               ("difference coupling", np.asarray(out.func_coupl_conv),
                "--"),
               ("difference constraints", np.asarray(out.func_constr_conv),
                ":")]
    par2 = np.asarray(out.func_PAR2_coupl)
    if np.any(par2 > 0):
        streams.append(("difference PAR2 coupling", par2, "-."))
    if out.func_rel_missing is not None:
        frm = np.asarray(out.func_rel_missing, dtype=float)
        if np.any(np.isfinite(frm)):
            streams.append(("rel. change missing", frm, (0, (3, 1, 1, 1))))

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))

    def pos(vals):
        # MATLAB semilogy drops nonpositive points; NaN does the same here
        v = np.asarray(vals, dtype=float).copy()
        v[v <= 0] = np.nan
        return v

    for name, vals, ls in streams:
        axes[0].semilogy(it[: len(vals)], pos(vals), linestyle=ls,
                         label=name)
    axes[0].set_xlabel("iterations")
    axes[0].set_ylabel("function value")
    axes[0].legend(fontsize=8)

    t = out.time_at_it
    if t is not None:
        t = np.asarray(t)
        for name, vals, ls in streams:
            n = min(len(t), len(vals))
            axes[1].semilogy(t[:n], pos(vals[:n]), linestyle=ls,
                             label=name)
        axes[1].set_xlabel("time in seconds")
        axes[1].set_ylabel("function value")
        axes[1].legend(fontsize=8)
    else:
        axes[1].set_axis_off()

    if out.innerIters is not None:
        inner = np.asarray(out.innerIters)
        markers = ["+", "o", "*", "x", "^", "v", "s", "d", ">", "<", "p",
                   "h"]
        for m in range(inner.shape[0]):
            if not np.any(inner[m]):
                continue
            label = (mode_names[m] if mode_names is not None
                     else f"mode {m + 1}")
            axes[2].plot(inner[m], markers[m % len(markers)],
                         markersize=3, label=label)
        axes[2].set_xlabel("outer iteration")
        axes[2].set_ylabel("inner iterations")
        axes[2].legend(fontsize=8)
    else:
        axes[2].set_axis_off()

    fig.suptitle(title)
    fig.tight_layout()
    if path:
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path, dpi=110)
    if show:
        plt.show()
    return fig
