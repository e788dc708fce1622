"""fit(mesh=) of the port on 2 gloo ranks with PARAFAC2 datasets cut along
K (matlab_code_tpu_torch/parallel/sharding.py: slices, Bk, P and
mu_DeltaB the rank's slices, C replicated), against the port's plain fit
and the JAX package's fit(mesh=make_mesh(2)), every rank's returned state
full and bit-equal: a regular PARAFAC2 dataset, the ragged non-negative
Bk case (kernel A's slice-wise prox on each rank's ragged slices; padded
rows exactly zero), tPARAFAC2 on Bk (replicated by fit(mesh=): the plain
fit's bits; and laid out by hand with par2='cut', the solve along K on the
gathered stack), the par2C type-1 coupling (the (K R)^2 kron system on the
gathered rows), EM imputation on the rank's slices, and the regular
dataset with inner_solve='newton' and par2_polar='ns' (the Newton
inverse's ill-conditioning flag psummed; the card's polar factor).  Tolerances:
tests/test_mesh_coupled.py's (the ragged case's are that file's for the
same configuration).  The ranks start once for the file; the JAX fits run
meanwhile."""
import dataclasses

import numpy as np
import pytest

import torch_mesh_cases as mc

CASES = {"regular": mc.par2_regular, "ragged": mc.par2_ragged,
         "tpar2": mc.par2_tpar2, "c_type1": mc.par2_c_type1,
         "em": mc.par2_em}
# the ragged configuration is ill-conditioned in Bk
# (test_mesh_ragged_parafac2_bucketed_prox): its file's tolerances.  The
# tPARAFAC2 one has not settled after 20 iterations (f_tensors, with its
# penalty, swings between 5 and 5000): the JAX package's own mesh fit is
# 7.9e-11 off its plain fit there, and its plain fit on the data times
# 1 + 2^-52 4.1e-11 off, so its trajectories are held at 1e-9
TOLS = {"ragged": dict(traj_rtol=1e-8, jax_rtol=1e-8, fac_atol=1e-4),
        "tpar2": dict(traj_rtol=1e-9, jax_rtol=1e-9),
        "tpar2_cut": dict(traj_rtol=1e-9, jax_rtol=1e-9)}
NEWTON_NS = dataclasses.replace(mc.OPTS, inner_solve="newton",
                                par2_polar="ns")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    problems = {k: fn() for k, fn in CASES.items()}
    tasks = [("fit", k, mc.payload(*pr)) for k, pr in problems.items()]
    problems["newton_ns"] = problems["regular"]
    tasks.append(("fit", "newton_ns", mc.payload(*problems["regular"],
                                                 options=NEWTON_NS)))
    problems["tpar2_cut"] = problems["tpar2"]
    tasks.append(("fit", "tpar2_cut", mc.payload(*problems["tpar2"],
                                                 par2="cut")))
    ranks = mc.start_ranks(tmp_path_factory.mktemp("par2_fit"), tasks)
    want = {k: mc.jax_mesh_fit(*pr) for k, pr in problems.items()
            if k not in ("newton_ns", "tpar2_cut")}
    want["tpar2_cut"] = want["tpar2"]
    want["newton_ns"] = mc.jax_mesh_fit(*problems["regular"],
                                        options=NEWTON_NS)
    return ranks.results(), want, problems


def _check(runs, name, axis=0):
    ranks, want, problems = runs
    st, out = want[name]
    r0 = mc.check_fit(ranks, name, out, st, **TOLS.get(name, {}))
    spec = problems[name][0]
    p = [ds.model for ds in spec.datasets].index("PAR2")
    # the PARAFAC2 dataset is cut along K (axis 0) or replicated (None);
    # the returned state is full
    assert r0["layout"][p] == axis
    K = spec.mode_sizes[spec.datasets[p].modes[2]]
    assert r0["mesh"]["fac"][spec.datasets[p].modes[1]].shape[0] == K
    return r0


def test_torch_mesh_par2_regular(runs):
    r0 = _check(runs, "regular")
    # the A mode's sums, DeltaB's and the residuals' psums, the par2C rows'
    # all_gather and the exit's gather of the cut leaves
    assert r0["mesh"]["counts"]["psum"] > 0
    assert r0["mesh"]["counts"]["all_gather"] > 0


def test_torch_mesh_par2_ragged_padded_rows_zero(runs):
    r0 = _check(runs, "ragged")
    for res in runs[0]:
        Bk = res["ragged"]["mesh"]["fac"][1]
        for k, J in enumerate(mc.RAGGED_SIZES):
            np.testing.assert_array_equal(Bk[k, J:, :], 0.0)
    np.testing.assert_array_equal(r0["mesh"]["fac"][1],
                                  runs[0][1]["ragged"]["mesh"]["fac"][1])


def test_torch_mesh_par2_tparafac2(runs):
    # fit(mesh=) replicates a tPARAFAC2 dataset: no collective, the plain
    # fit's bits on every rank
    r0 = _check(runs, "tpar2", axis=None)
    assert not any(r0["mesh"]["counts"].values())
    for res in runs[0]:
        for a, b in zip(res["tpar2"]["mesh"]["fac"], r0["plain"]["fac"]):
            np.testing.assert_array_equal(a, b)


def test_torch_mesh_par2_tparafac2_cut_by_hand(runs):
    # par2='cut', the JAX package's layout: kernel C's operand and rho
    # all-gathered every inner step
    r0 = _check(runs, "tpar2_cut")
    assert r0["mesh"]["counts"]["all_gather"] > 0


def test_torch_mesh_par2_c_type1_coupling(runs):
    r0 = _check(runs, "c_type1")
    # the CP dataset is cut too (its longest mode, 12 rows)
    assert r0["layout"][0] == 0


def test_torch_mesh_par2_em_missing(runs):
    ranks, want, _ = runs
    r0 = _check(runs, "em")
    out = want["em"][1]
    for res in ranks:
        got = res["em"]["mesh"]
        np.testing.assert_allclose(got["frm"], r0["plain"]["frm"],
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r0["mesh"]["frm"],
                               np.asarray(out.func_rel_missing),
                               rtol=1e-9, atol=1e-12)


def test_torch_mesh_par2_newton_and_ns_polar(runs):
    _check(runs, "newton_ns")
