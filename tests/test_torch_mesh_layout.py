"""The port's mesh layouts (matlab_code_tpu_torch/parallel/sharding.py)
make the JAX package's decisions: choose_cp_shard_mode, data_shardings'
cut for every CP dataset (dense, a matrix too, and COO with nnz divisible
and not) and every PARAFAC2 dataset (cut along K where the mesh size
divides K) and pad_sparse_nnz, for meshes of 1, 2, 4 and 8 devices; the
cut blocks concatenate back to the full data.  One process: the meshes
here only lay data out."""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import __graft_entry__ as ge
from matlab_code_tpu.parallel import shard_mttkrp as jsm
from matlab_code_tpu.parallel import sharding as jsh
from matlab_code_tpu.problem import SparseTensor as JSparse
from matlab_code_tpu_torch import convert
from matlab_code_tpu_torch.parallel import shard_mttkrp as tsm
from matlab_code_tpu_torch.parallel import sharding as tsh
from matlab_code_tpu_torch.problem import (
    Parafac2Tensor, SparseTensor, ProblemData)

import torch_mesh_cases as mc

NS = (1, 2, 4, 8)


def _problems():
    """(name, JAX spec, JAX data) of every CP layout the layouts meet."""
    out = [(name, *fn()[:2]) for name, fn in (
        ("type4", mc.type4_flagship), ("type1", mc.type1),
        ("type2", mc.type2), ("type3", mc.type3), ("type5", mc.type5),
        ("em", mc.em_missing), ("kl", mc.kl), ("par2", mc.par2_coupled))]
    spec, data, _ = mc.sparse_coo(8)
    out.append(("coo_padded", spec, data))
    X = data.objects[0]
    odd = JSparse(X.indices[:-3], X.values[:-3])     # nnz not divisible
    out.append(("coo_odd", spec, dataclasses.replace(data, objects=(odd,))))
    fspec, fdata, _, _ = ge._flagship(I0=16, J1=12, J2=16, K=8, Jb=10, R=3)
    out.append(("flagship", fspec, fdata))
    return out


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _jax_axis(sh):
    """The axis a JAX NamedSharding cuts, or None."""
    spec = tuple(sh.spec)
    return spec.index(jsh.DATA_AXIS) if jsh.DATA_AXIS in spec else None


def _port_data(data):
    return convert.data_from_numpy(
        [mc.numpy_object(X) for X in data.objects], data.coupl_trafo,
        data.coupl_trafo2, [None if m is None else np.asarray(m)
                            for m in data.miss], device="cpu")


@pytest.mark.parametrize("n", NS)
def test_torch_mesh_layout_matches_jax(n, problems):
    """choose_cp_shard_mode and data_shardings of every problem against the
    JAX package's on make_mesh(n), sharded_modes equal."""
    jmesh = jsh.make_mesh(n)
    tmesh = tsh.Mesh(size=n)
    for name, spec, data in problems:
        tspec, tdata = convert.spec_from_reference(spec), _port_data(data)
        jlay, jmodes = jsh.data_shardings(spec, data, jmesh)
        tlay, tmodes = tsh.data_shardings(tspec, tdata, tmesh)
        for p, ds in enumerate(spec.datasets):
            j, t = jlay.objects[p], tlay.objects[p]
            if ds.model == "CP":
                assert tsh.choose_cp_shard_mode(tspec, p, n) == \
                    jsh.choose_cp_shard_mode(spec, p, n), (name, p)
            if isinstance(j, NamedSharding):
                assert t.axis == _jax_axis(j), (name, p)
            elif isinstance(j, JSparse):
                assert isinstance(t, SparseTensor)
                assert t.values.axis == _jax_axis(j.values), (name, p)
                assert t.indices.axis == _jax_axis(j.indices), (name, p)
            else:
                # PARAFAC2: cut along K where n divides K, as the JAX one
                assert isinstance(t, Parafac2Tensor)
                assert t.slices.axis == _jax_axis(j.slices), (name, p)
                assert t.mask.axis == _jax_axis(j.mask), (name, p)
            if data.miss[p] is not None:
                assert tlay.miss[p].axis == _jax_axis(jlay.miss[p])
        assert tmodes == jmodes, name


def test_torch_mesh_pad_sparse_nnz_matches_jax():
    """pad_sparse_nnz: zero values at index 0, the JAX function's arrays."""
    spec, data, _ = mc.sparse_coo(1)
    X = data.objects[0]
    tX = SparseTensor(torch.tensor(np.asarray(X.indices)),
                      torch.tensor(np.asarray(X.values)))
    for n in NS + (3, 7):
        j, t = jsm.pad_sparse_nnz(X, n), tsm.pad_sparse_nnz(tX, n)
        assert t.indices.shape[0] % n == 0
        np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert tsm.pad_sparse_nnz(tX, 1) is tX


@pytest.mark.parametrize("n", (2, 4))
def test_torch_mesh_blocks_concatenate_to_the_data(n, problems):
    """Every rank's blocks (device_put) concatenate back to the full data
    along their cut axes, are row-major, and carry the layout; replicated
    data come whole."""
    for name, spec, data in problems:
        tspec, tdata = convert.spec_from_reference(spec), _port_data(data)
        blocks = []
        for r in range(n):
            mesh = tsh.Mesh(size=n, rank=r)
            lay, _ = tsh.data_shardings(tspec, tdata, mesh)
            put = tsh.device_put(tdata, lay)
            assert put.layout is lay and tsh.mesh_of(put) is mesh
            blocks.append(put)
        for p, X in enumerate(tdata.objects):
            sh = blocks[0].layout.objects[p]
            got = [b.objects[p] for b in blocks]
            if isinstance(X, SparseTensor):
                ax = sh.values.axis
                cat = (lambda xs: torch.cat(xs)) if ax == 0 else \
                    (lambda xs: xs[0])
                assert torch.equal(cat([g.indices for g in got]), X.indices)
                assert torch.equal(cat([g.values for g in got]), X.values)
            elif isinstance(X, Parafac2Tensor):
                ax = sh.slices.axis
                for part in ("slices", "mask"):
                    xs = [getattr(g, part) for g in got]
                    whole = xs[0] if ax is None else torch.cat(xs)
                    assert torch.equal(whole, getattr(X, part)), (name, p)
            else:
                whole = X if sh.axis is None else torch.cat(got, dim=sh.axis)
                if sh.axis is None:
                    assert all(torch.equal(g, X) for g in got)
                assert torch.equal(whole, X), (name, p)
                assert all(g.is_contiguous() for g in got)
                if tdata.miss[p] is not None:
                    mk = torch.cat([b.miss[p] for b in blocks], dim=sh.axis)
                    assert torch.equal(mk, tdata.miss[p])


def test_torch_mesh_state_replicated_and_factor_rows():
    """state_shardings replicates every leaf; lay_out keeps laid-out data
    as they are; a Shard's rows of a factor are its block's rows, a view."""
    spec, data, state = mc.type4_flagship()
    tspec, tdata = convert.spec_from_reference(spec), _port_data(data)
    tstate = convert.state_from_numpy(state, device="cpu")
    mesh = tsh.Mesh(size=2, rank=1)
    sh = tsh.state_shardings(tspec, tstate, mesh, {})
    assert all(s is None or s.axis is None
               for f in ("fac", "P", "coupling_fac") for s in getattr(sh, f))
    d1, s1 = tsh.lay_out(tspec, tdata, tstate, mesh)
    d2, s2 = tsh.lay_out(tspec, d1, s1, mesh)
    assert d2 is d1
    assert all(torch.equal(a, b) for a, b in zip(s1.fac, tstate.fac))
    U = tstate.fac[1]
    rows = tsh.Shard(mesh, 1).rows(U)
    assert torch.equal(rows, U[8:]) and rows.data_ptr() == U[8:].data_ptr()
    assert not tsh.dataset_shard(tdata, 0).cut
    assert tsh.dataset_shard(d1, 0).axis == 1
    with pytest.raises(ValueError, match="no process group"):
        tsh.Shard(mesh, 0).psum(torch.ones(1))
    assert ProblemData(objects=()).layout is None
