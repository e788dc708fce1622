"""fit(mesh=) of the port on 2 gloo ranks (matlab_code_tpu_torch/
parallel/) against the port's own plain fit (trajectory rtol 1e-11,
factors rtol 1e-8 / atol 1e-10) and the JAX package's fit(mesh=
make_mesh(2)) (trajectory rtol 1e-10), every rank's final state bit-equal:
the type-4 flagship shape, coupling types 1, 2, 3 and 5 (the coupled Delta
solves under cut MTTKRPs; tests/test_mesh_coupled.py's configurations)
and mesh_pipelined_collectives=True (the ring).  The ranks
(tests/torch_mesh_worker.py) start once for the file, the JAX fits run
meanwhile."""
import dataclasses

import pytest

import torch_mesh_cases as mc

CASES = {"type4": mc.type4_flagship, "type1": mc.type1, "type2": mc.type2,
         "type3": mc.type3, "type5": mc.type5}
RING = dataclasses.replace(mc.OPTS, mesh_pipelined_collectives=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    problems = {k: fn() for k, fn in CASES.items()}
    tasks = [("fit", k, mc.payload(*pr)) for k, pr in problems.items()]
    tasks.append(("fit", "ring", mc.payload(*problems["type4"],
                                            options=RING)))
    ranks = mc.start_ranks(tmp_path_factory.mktemp("fit_a"), tasks)
    want = {k: mc.jax_mesh_fit(*pr) for k, pr in problems.items()}
    want["ring"] = mc.jax_mesh_fit(*problems["type4"], options=RING)
    return ranks.results(), want


@pytest.mark.parametrize("name", list(CASES))
def test_torch_mesh_fit_coupling_types(runs, name):
    ranks, want = runs
    st, out = want[name]
    r0 = mc.check_fit(ranks, name, out, st)
    # every CP dataset is cut, its MTTKRPs through the sharded forms
    assert all(ax is not None for ax in r0["layout"].values())
    assert r0["impls"] and r0["mesh"]["counts"]["psum"] > 0


def test_torch_mesh_fit_pipelined_ring(runs):
    """mesh_pipelined_collectives=True routes every eligible target through
    the ring (a cut mode's own target and sizes the mesh does not divide
    keep the bulk form), with the plain fit's numbers."""
    ranks, want = runs
    st, out = want["ring"]
    r0 = mc.check_fit(ranks, "ring", out, st)
    forms = dict(r0["impls"])
    ring = {k for k, v in forms.items()
            if v == "make_sharded_mttkrp_pipelined"}
    # modes 0 (12 and 12 rows) of the two tensors; the cut modes (16, 24),
    # sizes 9 and 5 (odd) and the matrix keep the bulk form
    assert ring == {(0, 0), (1, 0)}
    assert r0["mesh"]["counts"]["ring"] > 0
