"""The benchmark's run: set-up, a measured window of jobs, the check
against the plain reference, and the result line.  Everything that belongs
to one configuration, traffic mix or metric is found by name:
  BENCHMARK.json             the cell -> its configuration and traffic mix
  configs/<config>.json      sizes, options, the generator module's name,
                             the reference module's path
  generators/<name>.py       make_raw(cfg, seed, device): the inputs;
                             to_program(raw, cfg): the program's problem
  reference/<name>.py        the plain reference (check.py)
  traffic/<traffic>.json     the program's entry, starts a job, iterations
                             a job, starts checked
  entries/<entry>.py         run(spec, data, options, init, keys) -> Job
  end_to_end/<metric>.py     read(run) -> the metric, or None
  layer_metrics/<metric>.py  read(run) -> the metric, or None
  limits/<cell>.json         the limit of each compared number
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from cardbench import check, trace
from cardbench.seeds import derive

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "matlab_code_tpu")
# the traced run profiles the jobs that start in its first TRACE_SECONDS
TRACE_SECONDS = 2.0


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench=None):
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            return bench, w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_reader(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Top-level names of loaded modules that this benchmark may not load,
    each compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def job_keys(seed, j, n_starts):
    return [derive(seed, "job", j, "start", s) for s in range(n_starts)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Cell:
    """A cell's configuration, traffic mix, generator and the program's
    entry, found by name."""

    def __init__(self, name, cfg_override=None, traffic_override=None):
        self.bench, w = find_cell(name)
        self.name = name
        self.cfg = load_json(HERE / "configs" / f"{w['config']}.json")
        self.cfg.update(cfg_override or {})
        self.traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        self.traffic.update(traffic_override or {})
        self.gen = importlib.import_module(
            f"cardbench.generators.{self.cfg['generator']}")
        self.entry = importlib.import_module(
            f"cardbench.entries.{self.traffic['entry']}")
        self.limits = load_json(HERE / "limits" / f"{name}.json")

    def problem(self, seed, device, **option_changes):
        """The program's problem for `seed` on `device`, its options with
        the job's iteration count.  Returns (spec, data, options,
        init_options, shapes)."""
        raw = self.gen.make_raw(self.cfg, seed, device)
        spec, data, options, init_options = self.gen.to_program(raw, self.cfg)
        options = dataclasses.replace(
            options, MaxOuterIters=self.traffic["max_outer_iters"],
            **option_changes)
        return spec, data, options, init_options, check.shapes_of(raw)

    def run_job(self, spec, data, options, init_options, keys):
        return self.entry.run(spec, data, options, init_options, keys)

    def check(self, seed, device, options, job):
        """The compared numbers of `job` (check.compare)."""
        return check.compare(self.gen, self.cfg, seed, device, options,
                             check.Sample.of(job),
                             self.traffic["check_starts"])


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             t_process0: float, device="cuda", cfg_override=None,
             traffic_override=None):
    """One run of a cell; returns the result line as a dict."""
    from matlab_code_tpu_torch.models import admm

    c = Cell(cell, cfg_override, traffic_override)
    bench, cfg, traffic = c.bench, c.cfg, c.traffic
    n_starts = traffic["n_starts"]

    # -- set-up: data on the device, then one whole job of the window's
    # own options from keys of its own, so that the window meets no shape
    # (such as a start axis that starts leave) for the first time
    spec, data, options, init_options, shapes = c.problem(seed, device)
    c.run_job(spec, data, options, init_options,
              [derive(seed, "warmup", s) for s in range(n_starts)])
    _sync(device)
    setup_s = time.perf_counter() - t_process0

    # -- the traced run profiles the jobs that start in its first
    # TRACE_SECONDS, then measures an untraced window as any run does
    jobs = []
    tr = None
    if traced:
        tr = trace.Trace(device)
        tr.start()
        t0 = time.perf_counter()
        while not jobs or time.perf_counter() - t0 < TRACE_SECONDS:
            jobs.append(c.run_job(spec, data, options, init_options,
                                  job_keys(seed, len(jobs), n_starts)))
        tr.stop()
    traced_jobs = list(jobs)

    # -- the window: jobs back to back until `seconds` have passed
    reads0 = admm.to_host.calls
    t0 = time.perf_counter()
    while len(jobs) == len(traced_jobs) or time.perf_counter() - t0 < seconds:
        jobs.append(c.run_job(spec, data, options, init_options,
                              job_keys(seed, len(jobs), n_starts)))
    _sync(device)
    window_s = time.perf_counter() - t0
    reads = admm.to_host.calls - reads0
    window_jobs = jobs[len(traced_jobs):]
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the benchmark may not load: "
                         f"{found}")

    # what the metric readers read (end_to_end/, layer_metrics/)
    run = types.SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, shapes=shapes, jobs=window_jobs,
        window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        host_reads=reads, trace=tr, traced_jobs=traced_jobs)
    kind = "layer_metrics" if traced else "end_to_end"
    metrics = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_reader(kind, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    attempted = sum(j.n_starts for j in jobs)
    failed = sum(j.failed for j in jobs)
    # -- the check: one job drawn from the seed, against the reference
    pick = jobs[int(np.random.default_rng(derive(seed, "pick")).integers(
        len(jobs)))]
    del jobs, run, data, spec
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = c.check(seed, device, options, pick)
    t_check = time.perf_counter() - t_check
    checks = {k: {"value": numbers[k], "limit": lim["limit"]}
              for k, lim in c.limits.items()}
    result = {
        "correct": bool(all(x["value"] <= x["limit"] for x in checks.values())
                        and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_record(device, peak, tr),
    }
    if tr:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.top_device_ops(10)],
            "idle_gaps": [[n, s] for n, s in tr.idle_by_host[:10]]}
    result["timings"] = {"window_s": window_s, "jobs": len(window_jobs),
                         "check_s": t_check,
                         **({"trace": tr.timings} if tr else {})}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the benchmark may not load: "
                         f"{found}")
    return result


def device_record(device, peak, tr):
    if torch.device(device).type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if tr:
        rec["busy_s"] = tr.busy_s
        rec["window_s"] = tr.window_s
    return rec
