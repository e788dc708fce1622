"""The port never loads jax, the JAX package or native/, and chip_smoke.py
refuses to report without a CUDA card or without the package beside it.
Each check runs in a fresh interpreter, because this test process has jax
loaded already."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "matlab_code_tpu_torch", "matlab_code_tpu_torch.problem",
    "matlab_code_tpu_torch.options", "matlab_code_tpu_torch.state",
    "matlab_code_tpu_torch.convert", "matlab_code_tpu_torch.ops.tensor",
    "matlab_code_tpu_torch.ops.mttkrp_cuda", "matlab_code_tpu_torch.ops._build",
    "matlab_code_tpu_torch.ops.linalg", "matlab_code_tpu_torch.ops.prox",
    "matlab_code_tpu_torch.ops.losses", "matlab_code_tpu_torch.models.updates",
    "matlab_code_tpu_torch.models.admm", "matlab_code_tpu_torch.models.objective",
    "matlab_code_tpu_torch.models.init", "matlab_code_tpu_torch.models.solver",
    "matlab_code_tpu_torch.utils.flagship",
    "matlab_code_tpu_torch.ops.sparse_cuda",
    "matlab_code_tpu_torch.utils.sparse_workload",
    "matlab_code_tpu_torch.ops.isotonic", "matlab_code_tpu_torch.ops.tv",
    "matlab_code_tpu_torch.ops.prox_cuda", "matlab_code_tpu_torch.utils.surface",
    "matlab_code_tpu_torch.utils.time_prox_seq",
    "matlab_code_tpu_torch.utils.time_mttkrp3", "matlab_code_tpu_torch.utils.timing",
    "matlab_code_tpu_torch.utils.par2_workload",
    "matlab_code_tpu_torch.utils.par2_surface",
    "matlab_code_tpu_torch.ops.loss_cuda", "matlab_code_tpu_torch.ops.lbfgsb",
    "matlab_code_tpu_torch.models.lbfgs_bridge",
    "matlab_code_tpu_torch.utils.kl_workload",
    "matlab_code_tpu_torch.models.pairwise",
    "matlab_code_tpu_torch.utils.checkpoint",
    "matlab_code_tpu_torch.utils.em_workload",
    "matlab_code_tpu_torch.ops.lanes", "matlab_code_tpu_torch.models.multistart",
    "matlab_code_tpu_torch.utils.multistart_workload",
    "matlab_code_tpu_torch.utils.time_fit",
    "matlab_code_tpu_torch.utils.time_par2_mesh",
    "matlab_code_tpu_torch.utils.score", "matlab_code_tpu_torch.utils.matlab_rng",
    "matlab_code_tpu_torch.utils.datagen", "matlab_code_tpu_torch.utils.plotting",
    "matlab_code_tpu_torch.examples", "matlab_code_tpu_torch.examples.common",
    "matlab_code_tpu_torch.examples.run_all",
    "matlab_code_tpu_torch.parallel", "matlab_code_tpu_torch.parallel.sharding",
    "matlab_code_tpu_torch.parallel.collectives",
    "matlab_code_tpu_torch.parallel.shard_mttkrp",
    "matlab_code_tpu_torch.parallel.distributed",
    "matlab_code_tpu_torch.utils.profiling",
] + [f"matlab_code_tpu_torch.examples.{name}" for name in (
    "script01_cp_par2_nonneg", "script01a_cp_par2_smooth_l2ball",
    "script02_matrix_par2_nonneg", "script03_matrix_cp_partialcoupling",
    "script04_irregular_par2", "script05_cp_cp_doublesampling_simplex",
    "script06_three_datasets", "script07_matrix_cp_kl",
    "script08_regular_par2_nonneg", "script09_par2_unimodality",
    "script10_cp_tv", "script11_tparafac2", "script12_cp_par2_em",
    "script13_cp_cp_type5", "script14_cp_par2_couplC", "script15_realdata")]


def _python(code, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO if cwd == REPO else ""
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_torch_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k in "
            "('jax', 'matlab_code_tpu', 'native') or "
            "k.startswith(('jax.', 'jaxlib', 'matlab_code_tpu.', 'native.')))\n"
            "print('LOADED', bad)\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_torch_port_builds_nothing_at_import():
    code = ("import matlab_code_tpu_torch.ops.mttkrp_cuda as k, "
            "matlab_code_tpu_torch.ops.sparse_cuda as s, "
            "matlab_code_tpu_torch.ops.prox_cuda as q, "
            "matlab_code_tpu_torch.ops.loss_cuda as d, "
            "matlab_code_tpu_torch.ops._build as b\n"
            "print('STATE', k._LIB is None, s._LIB is None, q._LIB is None, "
            "q._LIB_C is None, d._LIB is None, b.BUILD_LOGS == {})\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert "STATE True True True True True True" in proc.stdout


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})


def _no_result(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert '"kernels"' not in proc.stdout


def test_torch_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs for real there")
    _no_result(_run_smoke(REPO))


def test_torch_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    _no_result(_run_smoke(tmp_path))
