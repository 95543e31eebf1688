"""Checks only a GPU can answer: the plain assign + statistics pass and the
golden Hastings vectors, run on the card against float64 references.

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_card.py

Elsewhere every test here skips.  ``chip_smoke.py`` phase 4 runs the same
checks (``dpmmsubclusters_tpu.utils.reference``) at the same sizes.
"""
import pytest

import chip_smoke
from dpmmsubclusters_tpu.priors import GAUSSIAN, MULTINOMIAL
from dpmmsubclusters_tpu.utils import reference as R

pytestmark = pytest.mark.gpu

N, D, K = 65_536, 32, 128


@pytest.mark.parametrize("precompute", [True, False])
def test_gaussian_assign_matches_f64_on_card(gpu, precompute):
    prob = R.gaussian_problem(N, D, K, K - 8, seed=0, n_valid=N - N // 64)
    out = R.check_problem(prob, GAUSSIAN, 16384, precompute=precompute)
    assert out["ok"], out


def test_multinomial_assign_matches_f64_on_card(gpu):
    prob = R.multinomial_problem(N, 100, 16, 10, seed=0, n_valid=N - N // 64)
    out = R.check_problem(prob, MULTINOMIAL, 16384)
    assert out["ok"], out


@pytest.mark.parametrize("name,args", chip_smoke.GOLDEN_CASES)
def test_golden_mh_on_card(gpu, name, args):
    getattr(chip_smoke.load_golden(), name)(*args)
