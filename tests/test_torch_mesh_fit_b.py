"""fit(mesh=) of the port on 2 gloo ranks against its own plain fit and
the JAX package's fit(mesh=make_mesh(2)), every rank's final state
bit-equal: sparse COO data cut along the nonzeros, EM imputation of
missing entries on cut data, the KL loss (L-BFGS-B's loss pass on each
rank's block), a ragged PARAFAC2 dataset cut along K coupled with a cut
CP tensor, and cmtf_aoadmm(mesh=) from a seed against cmtf_aoadmm.
Tolerances: tests/test_mesh_coupled.py's for each configuration."""
import pytest

import torch_mesh_cases as mc
import matlab_code_tpu_torch as tp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    problems = {"sparse": mc.sparse_coo(), "em": mc.em_missing(),
                "kl": mc.kl(), "par2": mc.par2_coupled()}
    opts = {"kl": mc.KL_OPTS}
    tasks = [("fit", k, mc.payload(*pr, options=opts.get(k, mc.OPTS)))
             for k, pr in problems.items()]
    spec, data, _ = mc.type4_flagship()
    init = tp.InitOptions(distr=("rand",) * 8, normalize=True,
                          lambdas_init=((1,) * 3, (1,) * 3, (1,) * 2))
    tasks.append(("cmtf", "cmtf", mc.payload(spec, data, init_options=init,
                                             seed=5)))
    ranks = mc.start_ranks(tmp_path_factory.mktemp("fit_b"), tasks)
    want = {k: mc.jax_mesh_fit(*pr, options=opts.get(k, mc.OPTS))
            for k, pr in problems.items()}
    return ranks.results(), want


def test_torch_mesh_fit_sparse_coo(runs):
    ranks, want = runs
    r0 = mc.check_fit(ranks, "sparse", want["sparse"][1], want["sparse"][0],
                      fac_rtol=1e-9, fac_atol=1e-11)
    assert r0["impls"] == [((0, t), "make_sharded_mttkrp_sparse")
                           for t in range(3)]


def test_torch_mesh_fit_em_missing(runs):
    ranks, want = runs
    st, out = want["em"]
    r0 = mc.check_fit(ranks, "em", out, st)
    for res in ranks:
        got = res["em"]["mesh"]
        assert abs(got["f_rel_missing"] - r0["plain"]["f_rel_missing"]) <= \
            1e-9 * abs(r0["plain"]["f_rel_missing"]) + 1e-12
    assert abs(r0["mesh"]["f_rel_missing"] - float(out.f_rel_missing)) <= \
        1e-9 * abs(float(out.f_rel_missing)) + 1e-12


def test_torch_mesh_fit_kl(runs):
    ranks, want = runs
    st, out = want["kl"]
    mc.check_fit(ranks, "kl", out, st, traj_rtol=1e-11, jax_rtol=1e-9,
                 fac_rtol=1e-7, fac_atol=1e-9)


def test_torch_mesh_fit_par2_coupled_with_cut_cp(runs):
    """The ragged PARAFAC2 dataset is cut along K (8 slices, 4 a rank), the
    CP dataset coupled with it on mode A is cut along a mode."""
    ranks, want = runs
    st, out = want["par2"]
    r0 = mc.check_fit(ranks, "par2", out, st)
    assert r0["layout"][0] is not None and r0["layout"][1] == 0


def test_torch_mesh_cmtf_aoadmm_from_a_seed(runs):
    ranks, _ = runs
    mc.check_fit(ranks, "cmtf")
