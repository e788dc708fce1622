"""One job's result as the harness, the metric readers and the check read
it, whichever entry of the program ran it (cardbench/entries/)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Job:
    keys: list                 # each start's key (its initial state's seed)
    n_starts: int
    steps: int                 # outer iterations of the job (all starts)
    start_iters: int           # every start's outer iterations
    stop_iters: list           # each start's
    finals: np.ndarray         # each start's final f_tensors
    best: int                  # the start with the least final f_tensors
    factors: dict              # the best start's factors, by mode
    hist: np.ndarray           # the best start's f_tensors, iteration 0 on
    failed: int                # starts whose result is not finite
