"""The port's analysis statistics (emx_torch/analysis/{stats,pearson,
optim_demo}.py) against emx's on the same numpy inputs.

Tolerances: histograms and entropies exact counts (entropy rtol 1e-6);
Gram matrices rtol 1e-5; pearson is a copy (equal results); the
Rosenbrock race over 200 steps: final losses rtol 1e-5 for adam,
nesterov and adagrad, and trajectories within 1e-4; rmsprop rtol 5e-3
and trajectories within 1e-2, because its step is +-lr * sqrt(10)
wherever a gradient is near zero, so float32 rounding of a gradient that
crosses zero moves the point by ~lr (the two agree exactly for the
first 50 steps)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emx.analysis import optim_demo as emx_optim
from emx.analysis import pearson as emx_pearson
from emx.analysis import stats as emx_stats
from emx_torch.analysis import optim_demo, pearson, stats


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(3)
    return rng.standard_normal((12, 10, 7)).astype(np.float32)


def test_entropy_matches_emx():
    rng = np.random.default_rng(0)
    # One (non-square) shape for the three images, so that emx's eager
    # ops compile once per bin count.
    for img in (rng.random((16, 24)).astype(np.float32),
                rng.poisson(3.0, (16, 24)).astype(np.float32),
                np.full((16, 24), 2.0, np.float32)):
        for bins in (256, 7):
            ref = float(emx_stats.shannon_entropy(jnp.asarray(img), bins))
            got = float(stats.shannon_entropy(torch.from_numpy(img), bins))
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_gram_matrix_and_histogram_match_emx(feats):
    for normalize in (True, False):
        ref = np.asarray(emx_stats.gram_matrix(jnp.asarray(feats), normalize))
        got = stats.gram_matrix(torch.from_numpy(feats), normalize).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    rc, re = emx_stats.gram_histogram(jnp.asarray(feats), 20)
    gc, ge = stats.gram_histogram(torch.from_numpy(feats), 20)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(ge.numpy(), np.asarray(re), rtol=1e-5,
                               atol=1e-7)


def test_pearson_matches_emx():
    for skew, kurt in ((0.0, 3.0), (0.0, 2.2), (0.0, 4.5), (0.5, 2.5),
                       (1.0, 4.5), (1.2, 6.0), (0.3, 3.5)):
        assert pearson.classify_family(skew, kurt) == \
            emx_pearson.classify_family(skew, kurt)
    x = np.linspace(-2, 3, 9)
    for args in ((0.0, 1.0), (1.0, 2.0, 0.5, 3.5), (0.0, 1.0, 0.0, 2.4)):
        a = pearson.pearson_from_moments(*args)
        b = emx_pearson.pearson_from_moments(*args)
        assert a.family == b.family
        np.testing.assert_allclose(a.cdf(x), b.cdf(x), rtol=1e-12)
    sample = np.random.default_rng(1).gamma(2.0, size=400)
    ra = pearson.moment_redistributor(sample, 50)
    rb = emx_pearson.moment_redistributor(sample, 50)
    np.testing.assert_allclose(ra["transform"](sample),
                               rb["transform"](sample), rtol=1e-12)


EMX_OPTIMIZERS = {"adam": optax.adam(2e-2),
                  "nesterov": optax.sgd(2e-4, momentum=0.9, nesterov=True),
                  "rmsprop": optax.rmsprop(5e-3),
                  "adagrad": optax.adagrad(5e-1)}


@pytest.mark.parametrize("name", sorted(EMX_OPTIMIZERS))
def test_rosenbrock_race_matches_emx(name):
    steps = 200
    ref_traj, ref = emx_optim.optimize_rosenbrock(EMX_OPTIMIZERS[name],
                                                  steps)
    traj, got = optim_demo.optimize_rosenbrock(
        optim_demo.CANDIDATES[name], steps, device="cpu")
    rtol, atol = (5e-3, 1e-2) if name == "rmsprop" else (1e-5, 1e-4)
    np.testing.assert_allclose(got, ref, rtol=rtol)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), atol=atol)
    np.testing.assert_allclose(float(optim_demo.rosenbrock(
        torch.tensor([1.0, 1.0]))), 0.0)


def test_compare_optimizers_keys():
    """compare_optimizers races emx's four families (short race)."""
    got = optim_demo.compare_optimizers(steps=20, device="cpu")
    assert set(got) == set(EMX_OPTIMIZERS)
    assert all(np.isfinite(v) for v in got.values())
