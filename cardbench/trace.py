"""The traced run's reduction: torch.profiler (CPU and CUDA activity) over
the first jobs of the window, reduced to the device's operations (kernels,
copies, sets), their busy time (the union of their intervals), and the
idle gaps between them, each labelled by what the host was doing there:
the host operation that started last before the gap's middle, "in" it
where it still ran, "after" it where it had ended.  The profiler's raw
events are read directly (no per-event Python objects of its own), so a
trace of some millions of events reduces in seconds."""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch


class Trace:
    """Start with start(), stop with stop(); then the fields below."""

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.dev_names = []
        self.dev_start = np.zeros(0, np.int64)
        self.dev_dur = np.zeros(0, np.int64)
        self.idle_by_host = []

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self):
        self._sync()
        t = time.perf_counter()
        self.window_s = t - self._t0
        self.prof.__exit__(None, None, None)
        t_exit = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        t_events = time.perf_counter()
        self.prof = None
        self._reduce(events)
        self.timings = {"profiled_s": self.window_s, "exit_s": t_exit - t,
                        "events_s": t_events - t_exit, "n_events": len(events),
                        "reduce_s": time.perf_counter() - t_events}

    def _reduce(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        dn, ds, dd, hn, hs, he = [], [], [], [], [], []
        for e in events:
            if e.device_type() == cuda:
                dn.append(e.name())
                ds.append(e.start_ns())
                dd.append(e.duration_ns())
            else:
                hn.append(e.name())
                hs.append(e.start_ns())
                he.append(e.start_ns() + e.duration_ns())
        self.dev_names = dn
        self.dev_start = np.asarray(ds, np.int64)
        self.dev_dur = np.asarray(dd, np.int64)
        if not dn:
            return
        order = np.argsort(self.dev_start, kind="stable")
        s = self.dev_start[order]
        e = s + self.dev_dur[order]
        # merged busy intervals: a new one starts where an operation starts
        # after every earlier one has ended
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = run_end[np.append(idx[1:] - 1, len(s) - 1)]
        self.busy_s = float(np.sum(ends - starts)) / 1e9
        gap0, gap1 = ends[:-1], starts[1:]
        self.idle_by_host = self._label_gaps(gap0, gap1, hn, hs, he)

    @staticmethod
    def _label_gaps(gap0, gap1, names, hs, he):
        if len(gap0) == 0 or not names:
            return []
        hs = np.asarray(hs, np.int64)
        he = np.asarray(he, np.int64)
        order = np.argsort(hs, kind="stable")
        hs, he = hs[order], he[order]
        mid = (gap0 + gap1) // 2
        j = np.searchsorted(hs, mid, side="right") - 1
        total = defaultdict(float)
        for g, jj, m in zip((gap1 - gap0) / 1e9, j, mid):
            if jj < 0:
                total["before the first host operation"] += g
                continue
            k = order[jj]
            where = "in " if he[jj] >= m else "after "
            total[where + names[k]] += g
        return sorted(total.items(), key=lambda kv: -kv[1])

    def device_seconds(self, pattern) -> float:
        """Device time of the operations whose name matches `pattern` (a
        compiled regular expression)."""
        hit = [i for i, n in enumerate(self.dev_names) if pattern.search(n)]
        return float(np.sum(self.dev_dur[hit])) / 1e9 if hit else 0.0

    def top_device_ops(self, n: int = 10):
        total = defaultdict(float)
        for name, d in zip(self.dev_names, self.dev_dur):
            total[name] += d / 1e9
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]
