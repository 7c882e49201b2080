"""The port's dose probe and SSIM losses against emx's on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.train import dose_probe as emx_probe
from emx.train import losses as emx_losses
from emx_torch.train import dose_probe, losses

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("window", [1, 3, 5])
def test_moving_average_matches_emx(window):
    v = RNG.random(20).astype(np.float32)
    np.testing.assert_array_equal(dose_probe.moving_average(v, window),
                                  emx_probe.moving_average(v, window))


@pytest.mark.parametrize("case", ["improving", "flat", "mixed"])
def test_training_probs_match_emx(case):
    prev = RNG.random(20).astype(np.float32) + 1
    new = {"improving": prev - RNG.random(20).astype(np.float32) * 0.5,
           "flat": prev.copy(),
           "mixed": prev + RNG.normal(0, 0.2, 20).astype(np.float32)}[case]
    got = dose_probe.training_probs(prev, new)
    np.testing.assert_array_equal(got, emx_probe.training_probs(prev, new))
    assert got[-1] == pytest.approx(1.0) and np.all(np.diff(got) >= 0)


def test_sample_dose_matches_emx():
    """The same uniforms give emx's dose bins (emx draws its uniform
    from a key; the port takes the uniform)."""
    cum = dose_probe.training_probs(RNG.random(10) + 1, RNG.random(10) + 0.5)
    means = np.linspace(25, 400, 10).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), 200)
    want = np.array([float(emx_probe.sample_dose(k, jnp.asarray(cum),
                                                 jnp.asarray(means)))
                     for k in keys])
    u = torch.from_numpy(np.array([float(jax.random.uniform(k))
                                   for k in keys], np.float32))
    got = dose_probe.sample_dose(u, torch.from_numpy(cum),
                                 torch.from_numpy(means)).numpy()
    np.testing.assert_array_equal(got, want)


def test_probed_example_draws_from_the_cdf():
    """All the mass on one bin: every image gets that bin's dose; the
    pair is denoiser_example's (noisy in [0, 1], target at its mean)."""
    means = np.linspace(25, 400, 5).astype(np.float32)
    cum = np.array([0, 0, 1, 1, 1], np.float32)
    draws = dose_probe.probed_draws(4, 64, cum, means)
    assert torch.all(draws["scales"] == means[2])
    imgs = torch.rand(6, 16, 16, generator=torch.Generator().manual_seed(0))
    lq, tgt = dose_probe.probed_denoiser_example(4, imgs, cum, means)
    assert lq.shape == tgt.shape == (6, 16, 16)
    assert 0 <= float(lq.min()) and float(lq.max()) <= 1
    torch.testing.assert_close(tgt.mean((1, 2)), lq.mean((1, 2)),
                               rtol=1e-5, atol=1e-6)


def test_probe_updates_like_emx():
    ours, theirs = dose_probe.DoseProbe(8), emx_probe.DoseProbe(8)
    np.testing.assert_array_equal(ours.dose_means, theirs.dose_means)
    for _ in range(3):
        losses_ = RNG.random(8).astype(np.float32)
        np.testing.assert_array_equal(ours.update(losses_),
                                      theirs.update(losses_))


def test_probe_losses_fall_with_dose():
    """The identity 'model' against the clean target: a higher dose is
    less noisy, so the per-bin loss falls bin over bin."""
    p = dose_probe.DoseProbe(4, dose_min=5.0, dose_max=400.0)
    val = torch.from_numpy(RNG.random((3, 32, 32)).astype(np.float32))
    out = p.probe_losses(lambda x, train: x, val, seed=1)
    assert out.shape == (4,) and np.all(np.diff(out) < 0)


def _pair(shape=(2, 61, 57, 1)):
    a = RNG.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * RNG.standard_normal(shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("return_map", [False, True])
def test_ssim_matches_emx(return_map):
    """float32 sums in other orders: within 2e-5."""
    a, b = _pair()
    got = losses.ssim(torch.from_numpy(a), torch.from_numpy(b),
                      return_map=return_map).numpy()
    want = np.asarray(emx_losses.ssim(jnp.asarray(a), jnp.asarray(b),
                                      return_map=return_map))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 181, 179, 1), (1, 176, 176, 1)])
def test_ms_ssim_matches_emx(shape):
    """Odd sides take emx's SAME padding at the halvings: within 2e-5."""
    a, b = _pair(shape)
    got = float(losses.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(emx_losses.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, abs=2e-5)
    assert float(losses.ms_ssim(torch.from_numpy(a),
                                torch.from_numpy(a))) == pytest.approx(1.0)
