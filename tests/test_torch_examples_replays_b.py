"""The port's own reference-seeded replays of the CP example scripts (03,
05, 06, 10, 12, 13) against their goldens: see torch_examples_cases.py.
Script 12's replay also draws its randperm missing masks on the stream;
script 11's run_real() is held to the JAX script's on a small fixture."""
import pytest

from torch_examples_cases import CP, hold_replay


@pytest.mark.parametrize("mod,golden,N,least_fms", CP,
                         ids=[c[0][:8] for c in CP])
def test_torch_example_replay_cp(mod, golden, N, least_fms):
    res = hold_replay(mod, golden, N, least_fms)
    if mod.startswith("script12"):
        data = res["data"]
        for mask, X in zip(data.miss, data.objects):
            obs = mask if not hasattr(X, "slices") else \
                mask[X.mask[:, None, :].expand_as(mask)]
            share = 1 - float(obs.double().mean())
            assert abs(share - 0.2) < 1e-3, share    # round(0.2 n) missing
        assert res["out"].f_rel_missing < 1e-4


def test_torch_script11_run_real_on_a_fixture(tmp_path, monkeypatch):
    """Script 11's run_real() on .mat fixtures shaped as the reference's
    (gnd_factors.mat: A (I, R), B (K, J, R), C (K, R); noisy_dataset.mat:
    dataset (I, J, K)), small and written here, with the init drawn on the
    MATLAB stream: 5 iterations of the port against the JAX script's
    run_real (its fit cut to the same 5), the objective stream at rtol
    1e-9 and the scores within 1e-8."""
    import dataclasses

    import numpy as np
    import scipy.io as sio

    import matlab_code_tpu.models.solver as jsolver
    from examples.script11_tparafac2 import run_real as jax_run_real
    from matlab_code_tpu_torch.examples.script11_tparafac2 import run_real

    rng = np.random.default_rng(11)
    I, J, K, R, N = 12, 9, 6, 3, 5
    A = rng.uniform(size=(I, R))
    B = rng.uniform(size=(K, J, R))
    C = rng.uniform(0.5, 1.5, size=(K, R))
    X = np.stack([A @ np.diag(C[k]) @ B[k].T for k in range(K)], axis=2)
    X = X + 0.01 * rng.standard_normal(X.shape)
    sio.savemat(tmp_path / "gnd_factors.mat", {"A": A, "B": B, "C": C})
    sio.savemat(tmp_path / "noisy_dataset.mat", {"dataset": X})
    real_fit = jsolver.fit
    monkeypatch.setattr(jsolver, "fit", lambda spec, data, state, opts: real_fit(
        spec, data, state, dataclasses.replace(opts, MaxOuterIters=N)))
    want = jax_run_real(fixture_dir=str(tmp_path), verbose=False,
                        reference_init=True)
    got = run_real(fixture_dir=str(tmp_path), verbose=False,
                   reference_init=True, device="cpu", MaxOuterIters=N)
    assert got["out"].OuterIterations == N
    np.testing.assert_allclose(got["out"].func_val_conv,
                               want["out"].func_val_conv, rtol=1e-9, atol=0)
    for k in ("fit", "fms_A", "fms_B", "fms_C"):
        assert abs(got[k] - want[k]) <= 1e-8 * max(1.0, abs(want[k])), k
