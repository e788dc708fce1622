"""The port's best-of-N entry (models/multistart.fit_multistart, example
script 15's protocol): every start of a job on one start axis, each
stopping by the configuration's rule or at the job's MaxOuterIters."""
from __future__ import annotations

import numpy as np

from cardbench.job import Job


def run(spec, data, options, init_options, keys) -> Job:
    from matlab_code_tpu_torch.models.multistart import fit_multistart
    state, out, finals, stops = fit_multistart(
        spec, data, options, init_options, n_starts=len(keys), keys=keys)
    finals = np.asarray(finals, dtype=float)
    ok = np.isfinite(finals)
    return Job(keys=list(keys), n_starts=len(keys), steps=max(stops),
               start_iters=int(sum(stops)), stop_iters=list(stops),
               finals=finals,
               best=int(np.nanargmin(finals)) if ok.any() else 0,
               factors=dict(enumerate(state.fac)),
               hist=np.asarray(out.func_val_conv), failed=int((~ok).sum()))
