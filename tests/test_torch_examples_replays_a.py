"""The port's own reference-seeded replays of the PARAFAC2 example scripts
(01, 01a, 02, 04, 08, 09, 14) against their goldens: see
torch_examples_cases.py."""
import pytest

from torch_examples_cases import PAR2, hold_replay


@pytest.mark.parametrize("mod,golden,N,least_fms", PAR2,
                         ids=[c[0][:8] for c in PAR2])
def test_torch_example_replay_par2(mod, golden, N, least_fms):
    res = hold_replay(mod, golden, N, least_fms)
    if mod.startswith("script09"):
        assert res["out"].OuterIterations == N > 100   # past the Bk start
