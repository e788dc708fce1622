"""A whole run on the CPU at the test size: the result line's shape, the
modules the harness and the reference load, and the refusals (no card, no
program beside the benchmark)."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from cardbench import tiny
from cardbench.harness import ROOT, Cell, run_cell

torch.set_num_threads(1)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,traced", [("fusion.starts20", False),
                                         ("fusion.starts20", True)])
def test_result_line(cell, traced):
    cfg, traffic = tiny.overrides(cell)
    r = run_cell(cell, 2**31 + 77, 0.2, traced, time.perf_counter(),
                 device="cpu", cfg_override=cfg, traffic_override=traffic)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert ("breakdown" in r) == traced
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(Cell(cell).limits)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        # the CPU has no device operations to read
        assert {"host_reads_per_step", "step_mfu"} <= set(r["metrics"])
    else:
        assert {"start_iters_per_s", "peak_mem_gib", "setup_s"} <= set(
            r["metrics"])
    json.dumps(r)


def _python(code, **env):
    e = dict(os.environ, PYTHONPATH=str(ROOT), **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=e, timeout=600)


def test_no_forbidden_modules_after_a_run():
    code = (
        "import sys, time\n"
        "from cardbench import tiny\n"
        "from cardbench.harness import run_cell, forbidden_modules\n"
        "for cell in ('fusion.starts20',):\n"
        "    cfg, tr = tiny.overrides(cell)\n"
        "    run_cell(cell, 5, 0.1, True, time.perf_counter(), device='cpu',\n"
        "             cfg_override=cfg, traffic_override=tr)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(t for t in tops if t in "
        "('jax', 'jaxlib', 'flax', 'matlab_code_tpu')), forbidden_modules())\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] []"


def test_reference_loads_nothing_of_the_program():
    cfg = ROOT / "cardbench" / "configs" / "fusion.json"
    p = _python("import sys\n"
                "import json, cardbench.check as c\n"
                f"c.load_reference(json.load(open({str(cfg)!r})))\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    assert p.returncode == 0, p.stderr[-2000:]
    tops = eval(p.stdout.strip().splitlines()[-1])
    for bad in ("jax", "jaxlib", "flax", "matlab_code_tpu",
                "matlab_code_tpu_torch"):
        assert bad not in tops


def test_run_fails_without_a_card():
    p = subprocess.run(
        [sys.executable, str(ROOT / "cardbench" / "run.py"), "--workload",
         "fusion.starts20", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_run_fails_beside_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "fusion.starts20",
         "--seed", "9", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
