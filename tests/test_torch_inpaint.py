"""The port's classical infills (emx_torch/analysis/inpaint.py) against
emx's on the CPU: the five fills, masked_psnr and compare_infills on the
same partial scans (emx's fixed 1/16 mask at 64x64, values in [-1, 1]).
Tolerance: 1e-5 absolute on the fills (float32; the port sums shifted
copies where emx convolves, and harmonic_fill's 400 sweeps carry that
rounding), 1e-4 dB on the PSNRs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.analysis.inpaint import compare_infills as flax_compare
from emx.analysis.inpaint import harmonic_fill as flax_harmonic
from emx.analysis.inpaint import masked_psnr as flax_masked_psnr
from emx.analysis.inpaint import nearest_fill as flax_nearest
from emx.analysis.inpaint import normconv_fill as flax_normconv
from emx.data.degrade import fixed_scan_mask as flax_mask
from emx_torch.analysis.inpaint import (compare_infills, harmonic_fill,
                                        masked_psnr, nearest_fill,
                                        normconv_fill)
from emx_torch.data.degrade import (apply_partial_scan, fixed_scan_mask,
                                    norm_neg1to1)
from emx_torch.data.pipeline import synthetic_micrographs

SIZE, COVERAGE = 64, 1 / 16


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scans():
    clean = norm_neg1to1(torch.from_numpy(
        synthetic_micrographs(3, SIZE, seed=4)))
    mask = fixed_scan_mask((SIZE, SIZE), COVERAGE)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(flax_mask((SIZE, SIZE), COVERAGE)))
    return apply_partial_scan(clean, mask), clean, mask


FILL_CASES = {
    "normconv_s2": (lambda x, m: flax_normconv(x, m, 2.0),
                    lambda x, m: normconv_fill(x, m, 2.0)),
    "normconv_s4": (lambda x, m: flax_normconv(x, m, 4.0),
                    lambda x, m: normconv_fill(x, m, 4.0)),
    "normconv_s8": (lambda x, m: flax_normconv(x, m, 8.0),
                    lambda x, m: normconv_fill(x, m, 8.0)),
    "nearest": (flax_nearest, nearest_fill),
    "harmonic": (flax_harmonic, harmonic_fill),
}


@pytest.mark.parametrize("name", list(FILL_CASES))
def test_fill_matches_emx(scans, name):
    masked, _, mask = scans
    flax_fn, port_fn = FILL_CASES[name]
    mj = jnp.asarray(mask.numpy())
    ref = np.asarray(jax.jit(jax.vmap(lambda x: flax_fn(x, mj)))(
        jnp.asarray(masked.numpy())))
    got = port_fn(masked, mask).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # Scanned pixels pass through unchanged.
    np.testing.assert_array_equal(got[:, mask.numpy()],
                                  masked.numpy()[:, mask.numpy()])


def test_masked_psnr_matches_emx_and_ignores_scanned_pixels(scans):
    masked, clean, mask = scans
    pred = clean + 0.1
    got = masked_psnr(pred, clean, mask, 2.0).numpy()
    mj = jnp.asarray(mask.numpy())
    ref = np.asarray(jax.vmap(lambda p, t: flax_masked_psnr(
        p, t, mj, 2.0))(jnp.asarray(pred.numpy()), jnp.asarray(clean.numpy())))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # Changing scanned pixels does not move the score.
    moved = torch.where(mask, pred + 5.0, pred)
    np.testing.assert_allclose(masked_psnr(moved, clean, mask, 2.0).numpy(),
                               got, atol=1e-5)


def test_compare_infills_matches_emx(scans):
    masked, clean, mask = scans

    def nn_port(x):
        return torch.where(mask, x, torch.zeros_like(x))

    def nn_flax(x):
        return jnp.where(jnp.asarray(mask.numpy()), x, 0.0)

    got = compare_infills(masked, clean, mask, nn_fn=nn_port, max_val=2.0)
    ref = flax_compare(jnp.asarray(masked.numpy()), jnp.asarray(
        clean.numpy()), jnp.asarray(mask.numpy()), nn_fn=nn_flax,
        max_val=2.0)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k]["psnr_masked"] == pytest.approx(
            ref[k]["psnr_masked"], abs=1e-4), k
