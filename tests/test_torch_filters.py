"""The port's classical filters and comparison harness against emx's
(emx/analysis/filters.py) on the same numpy images, in float32.

Tolerance: 1e-5 absolute on outputs in [0, 1] (float32 sums in another
order); PSNRs within 1e-4 dB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.analysis import filters as emx_filters
from emx.data.degrade import gaussian_blur as emx_blur
from emx_torch.analysis import filters
from emx_torch.data.degrade import gaussian_blur

TOL = 1e-5


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    clean = rng.random((3, 64, 64)).astype(np.float32)
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape),
                    0, 1).astype(np.float32)
    return noisy, clean


@pytest.mark.parametrize("name", list(emx_filters.DEFAULT_FILTERS))
def test_default_filter_matches_emx(images, name):
    noisy, _ = images
    ref = np.asarray(jax.vmap(emx_filters.DEFAULT_FILTERS[name])(
        jnp.asarray(noisy)))
    got = filters.DEFAULT_FILTERS[name](torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_filters_take_one_image_and_other_radii(images):
    """A 2D image as emx's filters take it, and non-default radii."""
    img = images[0][0]
    cases = [(emx_filters.median_filter, filters.median_filter, (2,)),
             (emx_filters.wiener_filter, filters.wiener_filter, (2, 0.01)),
             (emx_filters.bilateral_filter, filters.bilateral_filter,
              (1, 1.0, 0.2)),
             (emx_filters.wavelet_denoise, filters.wavelet_denoise, (0.05,)),
             (emx_filters.chambolle_tv, filters.chambolle_tv, (0.2, 10))]
    for ref_fn, fn, args in cases:
        ref = np.asarray(ref_fn(jnp.asarray(img), *args))
        got = fn(torch.from_numpy(img), *args).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
def test_gaussian_blur_matches_emx(images, sigma):
    noisy, _ = images
    ref = np.asarray(emx_blur(jnp.asarray(noisy), sigma))
    got = gaussian_blur(torch.from_numpy(noisy), sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_median_of_even_count_is_the_midpoint():
    """jnp.median's even rule (the wavelet threshold takes the median of
    an even number of coefficients); torch.median takes the lower."""
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(filters._median(x)) == float(jnp.median(jnp.asarray(
        [4.0, 1.0, 3.0, 2.0]))) == 2.5


def test_compare_denoisers_matches_emx(images):
    noisy, clean = images

    def nn(x):
        return 0.5 * x + 0.25

    ref = emx_filters.compare_denoisers(jnp.asarray(noisy),
                                        jnp.asarray(clean), nn_fn=nn,
                                        per_image=True)
    got = filters.compare_denoisers(torch.from_numpy(noisy),
                                    torch.from_numpy(clean), nn_fn=nn,
                                    per_image=True)
    assert list(got) == list(ref)
    for k in ref:
        assert abs(got[k]["psnr"] - ref[k]["psnr"]) < 1e-4
        np.testing.assert_allclose(got[k]["mse"], ref[k]["mse"], rtol=1e-4)
        np.testing.assert_allclose(got[k]["psnrs"], ref[k]["psnrs"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[k]["mses"], ref[k]["mses"],
                                   rtol=1e-4)


def test_save_err_hists_matches_emx(images, tmp_path):
    noisy, clean = images
    ref = emx_filters.compare_denoisers(jnp.asarray(noisy),
                                        jnp.asarray(clean), per_image=True)
    got = filters.compare_denoisers(torch.from_numpy(noisy),
                                    torch.from_numpy(clean), per_image=True)
    h_ref = emx_filters.save_err_hists(ref, str(tmp_path / "emx"), bins=8)
    h_got = filters.save_err_hists(got, str(tmp_path / "port"), bins=8)
    assert list(h_got) == list(h_ref)
    for k in h_ref:
        assert np.abs(h_got[k] - h_ref[k]).sum() <= 1   # a bin edge tie
        assert (tmp_path / "port" / f"{k}-losses.npy").exists()
    assert (tmp_path / "port" / "err_hist.npz").exists()
