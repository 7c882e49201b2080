"""The port's J-invariant selection (emx_torch/serve/select.py) against
emx's (emx/serve/select.py) on the same numpy data and masks.

emx draws its masks with jax.random; the test draws the same masks
with jax and gives them to the port's `masked_score`, so the scores
must agree: 1e-5 relative in float32 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.analysis.filters import gaussian_filter as emx_gaussian
from emx.serve import select as emx_select
from emx_torch.analysis.filters import gaussian_filter
from emx_torch.serve import select

FRAC = 0.05


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:40].astype(np.float32) / 48
    clean = 0.5 + 0.3 * np.sin(6 * xx + 3 * yy)
    return np.clip(clean + 0.15 * rng.standard_normal((3, 48, 40)),
                   0, 1).astype(np.float32)


def _jax_masks(key, n, shape, frac=FRAC):
    return np.stack([np.asarray(jax.random.bernoulli(k, frac, shape))
                     for k in jax.random.split(key, n)])


def test_masked_replace_matches_emx(noisy):
    mask = _jax_masks(jax.random.key(1), 1, noisy.shape, 0.3)[0]
    ref = np.asarray(jax.vmap(emx_select._masked_replace)(
        jnp.asarray(noisy), jnp.asarray(mask)))
    got = select._masked_replace(torch.from_numpy(noisy),
                                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # The masked pixel never reaches its own fill.
    np.testing.assert_array_equal(got[~mask], noisy[~mask])


@pytest.mark.parametrize("n_masks", [1, 3])
def test_masked_score_matches_emx(noisy, n_masks):
    key = jax.random.key(4)
    masks = _jax_masks(key, n_masks, noisy.shape)
    ref = np.asarray(emx_select.j_invariant_score(
        jax.vmap(lambda x: emx_gaussian(x, 1.0)), jnp.asarray(noisy), key,
        n_masks=n_masks, frac=FRAC))
    got = select.masked_score(lambda x: gaussian_filter(x, 1.0),
                              torch.from_numpy(noisy),
                              torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_auto_denoise_picks_per_image_and_returns_its_output(noisy):
    """A flat grey frame against a gaussian on noisy smooth fields: the
    gaussian wins every image in both packages, and the output is the
    winner's."""
    x = torch.from_numpy(noisy)
    cands = [lambda b: torch.full_like(b, 0.5),
             lambda b: gaussian_filter(b, 1.0)]
    out, chosen = select.auto_denoise(x, cands, seed=3, n_masks=2)
    _, ref_chosen = emx_select.auto_denoise(
        jnp.asarray(noisy), [lambda b: jnp.full_like(b, 0.5), jax.vmap(
            lambda b: emx_gaussian(b, 1.0))], jax.random.key(3), n_masks=2)
    assert chosen.tolist() == np.asarray(ref_chosen).tolist() == [1, 1, 1]
    torch.testing.assert_close(out, gaussian_filter(x, 1.0), rtol=0, atol=0)


def test_auto_denoise_is_deterministic_per_seed(noisy):
    x = torch.from_numpy(noisy)
    names, cands = select.serving_candidates(lambda b: b * 0.9)
    assert names == ["nn", "gaussian", "median", "wiener", "tv"]
    a = select.auto_denoise(x, cands, seed=0, n_masks=2)
    b = select.auto_denoise(x, cands, seed=0, n_masks=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    scores = torch.stack([select.j_invariant_score(fn, x, select.fold_in(
        0, i), n_masks=2) for i, fn in enumerate(cands)])
    assert torch.equal(a[1], scores.argmin(dim=0))
