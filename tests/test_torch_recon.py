"""The port's physics and reconstruction (emx_torch/physics/{ctf,propagate}.py,
emx_torch/recon/{ewrec,align,fit}.py) against emx's on the CPU, on the
same numpy inputs, and against the committed goldens tests/golden/ctf.npy
and tests/golden/ewrec_wave.npy.

Tolerances (float32 / complex64 on both sides; pocketfft in torch,
ducc in XLA): CTFs 1e-5, propagation 1e-4, GS waves 1e-4 after 30
iterations, the weak-phase residual rtol 1e-4; the phase-correlation
shifts 1e-4 px; gradients through the complex FFTs rtol 1e-3 (against
jax.grad); the Adam-driven fits (refine_defocuses, register_affine,
fit_exit_wave) within 1e-3 relative of emx's trajectories, except
fit_exit_wave's per-pixel wave: max 1e-2, mean 1e-4 (see there)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.physics import ctf as flax_ctf
from emx.physics import propagate as flax_prop
from emx.recon import align as flax_align
from emx.recon import fit as flax_fit
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.physics import ctf, propagate
from emx_torch.recon import (AberrationFitConfig, EWRECConfig, affine_warp,
                             align_stack, common_crop_slices, deconstruct,
                             defocus_search, ewrec, fit_exit_wave,
                             fourier_shift, phase_correlation, reconstruct,
                             reconstruction_loss, refine_defocuses,
                             register_affine, weak_phase_reconstruct,
                             weak_phase_residual)

# emx.recon's __init__ exports the function `ewrec` under the module's name.
flax_ewrec = importlib.import_module("emx.recon.ewrec")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG = EWRECConfig(wavelength=0.025, px_dim=1.0, num_iter=30)
FCFG = flax_ewrec.EWRECConfig(wavelength=0.025, px_dim=1.0, num_iter=30)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def make_wave(n=64, seed=0):
    """emx's tests/test_recon.py make_wave: a smooth complex exit wave."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    amp = 1.0 + 0.1 * np.sin(2 * np.pi * (2 * xx + yy))
    phase = np.zeros((n, n), np.float32)
    for _ in range(4):
        cy, cx = rng.uniform(0.2, 0.8, 2)
        s = rng.uniform(0.05, 0.15)
        phase += rng.uniform(0.2, 0.8) * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s ** 2)))
    return (amp * np.exp(1j * phase)).astype(np.complex64)


def focal_series(wave, defocuses):
    """|propagate_back(wave, df)|^2 for each defocus, from emx (numpy)."""
    return np.stack([np.asarray(jnp.abs(flax_prop.propagate_back_to_defocus(
        jnp.asarray(wave), df, 0.025)) ** 2) for df in defocuses])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_ctf_golden_and_wavelength():
    g = np.load(os.path.join(GOLDEN, "ctf.npy"))
    k = ctf.defocus_ctf(64, 0.025, 150.0)
    np.testing.assert_allclose(np.stack([k.real.numpy(), k.imag.numpy()]), g,
                               atol=1e-5)
    for kev in (80.0, 200.0, 300.0):
        assert ctf.energy_to_wavelength(kev) == pytest.approx(
            flax_ctf.energy_to_wavelength(kev), rel=1e-12)


@pytest.mark.parametrize("envelopes", [False, True])
def test_full_ctf_matches_emx(envelopes):
    vals = {"a20": 40.0, "a22": 12.0, "phi22": 0.3, "a31": 300.0,
            "phi31": -0.4, "a33": 150.0, "a40": 2.0e4, "a44": 900.0,
            "phi44": 1.1, "a51": 1.0e5, "a60": 3.0e6, "phi66": 0.2}
    kw = (dict(focal_spread=30.0, convergence_angle=5e-4, aperture=0.02,
               aperture_edge=0.004) if envelopes else {})
    ref = np.asarray(flax_ctf.full_ctf((48, 40), (0.5, 0.6), 0.025,
                                       flax_ctf.Aberrations(**vals), **kw))
    got = ctf.full_ctf((48, 40), (0.5, 0.6), 0.025, ctf.Aberrations(**vals),
                       **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_propagation_matches_emx():
    wave = make_wave(48, seed=3)
    dfs = np.asarray([-200.0, 50.0, 300.0], np.float32)
    for pad in (0.0, 0.5):
        ref = np.asarray(jax.vmap(lambda d: flax_prop.propagate_back_to_defocus(
            jnp.asarray(wave), d, 0.025, pad_periods=pad))(jnp.asarray(dfs)))
        got = propagate.propagate_back_to_defocus(_t(wave), _t(dfs), 0.025,
                                                  pad_periods=pad).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)
    stack = focal_series(wave, dfs).astype(np.complex64)
    ref = np.asarray(flax_prop.propagate_stack_to_focus(
        jnp.asarray(stack), jnp.asarray(dfs), 0.025))
    got = propagate.propagate_stack_to_focus(_t(stack), _t(dfs), 0.025)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_reconstruct_matches_emx_and_golden():
    """The GS loop against emx's on a 5-slice stack, and the golden
    ewrec_wave case (tests/test_golden.py: synthetic_micrographs(1, 64,
    seed=123), three planes, 10 iterations)."""
    wave = make_wave()
    dfs = np.asarray([-300.0, -150.0, 0.0, 150.0, 300.0], np.float32)
    amps = np.sqrt(focal_series(wave, dfs)).astype(np.float32)
    ref = np.asarray(flax_ewrec.reconstruct(jnp.asarray(amps),
                                            jnp.asarray(dfs), FCFG))
    got = reconstruct(_t(amps), _t(dfs), CFG).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    corr = abs(np.vdot(got, wave)) / (np.linalg.norm(got)
                                      * np.linalg.norm(wave))
    assert corr > 0.98
    np.testing.assert_allclose(
        deconstruct(_t(got), _t(dfs), CFG).numpy(),
        np.asarray(flax_ewrec.deconstruct(jnp.asarray(ref), jnp.asarray(dfs),
                                          FCFG)), atol=1e-4)

    x = synthetic_micrographs(1, 64, seed=123)[0].astype(np.complex64)
    gdfs = np.asarray([-150.0, 0.0, 150.0], np.float32)
    stack = torch.abs(propagate.propagate_back_to_defocus(
        _t(x), _t(gdfs), 0.025)) ** 2
    w = reconstruct(torch.sqrt(stack), _t(gdfs), EWRECConfig(num_iter=10))
    g = np.load(os.path.join(GOLDEN, "ewrec_wave.npy"))
    np.testing.assert_allclose(w.numpy(), g[0] * np.exp(1j * g[1]),
                               atol=1e-4)


def test_weak_phase_and_loss_match_emx():
    wave = make_wave(seed=1)
    ramp = np.asarray([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
    stack = focal_series(wave, 120.0 * ramp).astype(np.float32)
    for inc in (30.0, 120.0, 480.0):
        d = np.float32(inc) * ramp
        ref = float(flax_ewrec.weak_phase_residual(jnp.asarray(stack),
                                                   jnp.asarray(d), FCFG))
        got = float(weak_phase_residual(_t(stack), _t(d), CFG))
        assert got == pytest.approx(ref, rel=1e-4, abs=1e-7), inc
    d = 120.0 * ramp
    np.testing.assert_allclose(
        weak_phase_reconstruct(_t(stack), _t(d), CFG).numpy(),
        np.asarray(flax_ewrec.weak_phase_reconstruct(
            jnp.asarray(stack), jnp.asarray(d), FCFG)), atol=1e-4)
    amps = np.sqrt(stack)
    assert float(reconstruction_loss(_t(amps), _t(d), CFG)) == pytest.approx(
        float(flax_ewrec.reconstruction_loss(jnp.asarray(amps),
                                             jnp.asarray(d), FCFG)),
        rel=1e-3, abs=1e-8)


def test_defocus_search_and_ewrec_match_emx():
    wave = make_wave(seed=2)
    ramp = np.asarray([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
    stack = focal_series(wave, 100.0 * ramp).astype(np.float32)
    amps = np.sqrt(stack)
    kw = dict(num_candidates=12, min_incr=25.0, max_incr=400.0,
              refine_rounds=2)
    ref, ref_dfs = flax_ewrec.defocus_search(jnp.asarray(amps), FCFG, **kw)
    best, dfs = defocus_search(_t(amps), CFG, **kw)
    assert float(best) == float(ref)
    np.testing.assert_array_equal(dfs.numpy(), np.asarray(ref_dfs))
    out = ewrec(_t(stack), CFG, defocuses=dfs)
    ref_out = flax_ewrec.ewrec(jnp.asarray(stack), FCFG, defocuses=ref_dfs)
    np.testing.assert_allclose(out["exit_wave"].numpy(),
                               np.asarray(ref_out["exit_wave"]), atol=1e-4)
    assert float(out["loss"]) == pytest.approx(float(ref_out["loss"]),
                                               rel=1e-3, abs=1e-8)
    # numpy in, the CPU on request; the search alone finds the increment.
    found = ewrec(stack, CFG, device="cpu")
    assert float(found["defocuses"][-1]) == pytest.approx(200.0, rel=0.1)


def test_refine_defocuses_gradient_and_steps_match_emx():
    """The gradient of the reconstruction loss in the defocuses (a real
    loss through complex FFTs) against jax.grad, and three Adam steps of
    refine_defocuses against emx's."""
    wave = make_wave(32, seed=5)
    true = np.asarray([-200.0, 0.0, 200.0], np.float32)
    amps = np.sqrt(focal_series(wave, true)).astype(np.float32)
    start = true * np.asarray([1.05, 1.0, 0.96], np.float32)
    small = EWRECConfig(num_iter=10)
    fsmall = flax_ewrec.EWRECConfig(num_iter=10)
    ref_g = np.asarray(jax.grad(lambda d: flax_ewrec.reconstruction_loss(
        jnp.asarray(amps), d, fsmall))(jnp.asarray(start)))
    d = _t(start).clone().requires_grad_(True)
    reconstruction_loss(_t(amps), d, small).backward()
    np.testing.assert_allclose(d.grad.numpy(), ref_g, rtol=1e-3,
                               atol=1e-3 * np.abs(ref_g).max())
    ref = np.asarray(flax_ewrec.refine_defocuses(
        jnp.asarray(amps), jnp.asarray(start), fsmall, steps=3, lr=2.0))
    got = refine_defocuses(_t(amps), _t(start), small, steps=3, lr=2.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_phase_correlation_and_align_stack_match_emx():
    rng = np.random.default_rng(1)
    base = rng.random((48, 48)).astype(np.float32)
    shifts = np.asarray([(-4.0, 2.0), (-2.3, 1.0), (0.0, 0.0), (2.0, -1.4),
                         (4.0, -2.0)], np.float32)
    stack = np.stack([np.asarray(flax_align.fourier_shift(
        jnp.asarray(base), jnp.asarray(s))) for s in shifts])
    np.testing.assert_allclose(
        fourier_shift(_t(base), _t(shifts[1])).numpy(), stack[1], atol=1e-5)
    for i in (0, 1, 3):
        ref = np.asarray(flax_align.phase_correlation(
            jnp.asarray(stack[2]), jnp.asarray(stack[i])))
        got = phase_correlation(_t(stack[2]), _t(stack[i])).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)
    ref_al, ref_sh = flax_align.align_stack(jnp.asarray(stack))
    al, sh = align_stack(_t(stack))
    np.testing.assert_allclose(sh.numpy(), np.asarray(ref_sh), atol=1e-4)
    np.testing.assert_allclose(al.numpy(), np.asarray(ref_al), atol=1e-4)
    assert common_crop_slices(sh, (48, 48)) == flax_align.common_crop_slices(
        ref_sh, (48, 48))


def _blurred(seed, n):
    rng = np.random.default_rng(seed)
    base = rng.random((n, n)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    return np.stack([np.convolve(r, k, mode="same") for r in base]
                    ).astype(np.float32)


def test_affine_warp_and_its_gradient_match_emx():
    """map_coordinates(order=1, mode="nearest"), coordinates beyond the
    edge included, and its gradient in (A, t) against jax.grad."""
    base = _blurred(5, 40)
    a = np.asarray([[0.97, -0.08], [0.06, 1.03]], np.float32)
    t = np.asarray([2.5, -3.25], np.float32)
    ref = np.asarray(flax_align.affine_warp(jnp.asarray(base), jnp.asarray(a),
                                            jnp.asarray(t)))
    got = affine_warp(_t(base), _t(a), _t(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    w = np.random.default_rng(0).random((40, 40)).astype(np.float32)

    def f_loss(aa, tt):
        return jnp.sum(jnp.asarray(w) * flax_align.affine_warp(
            jnp.asarray(base), aa, tt))

    ga, gt = jax.grad(f_loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(t))
    aa = _t(a).clone().requires_grad_(True)
    tt = _t(t).clone().requires_grad_(True)
    torch.sum(_t(w) * affine_warp(_t(base), aa, tt)).backward()
    np.testing.assert_allclose(aa.grad.numpy(), np.asarray(ga), rtol=1e-3)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=1e-3)


def test_register_affine_matches_emx():
    base = _blurred(5, 48)
    th = 0.05
    a_true = np.asarray([[np.cos(th), -np.sin(th)],
                         [np.sin(th), np.cos(th)]], np.float32)
    t_true = np.asarray([2.0, -1.5], np.float32)
    moving = np.asarray(flax_align.affine_warp(
        jnp.asarray(base), jnp.asarray(a_true), jnp.asarray(t_true)))
    ra, rt, rw = flax_align.register_affine(jnp.asarray(moving),
                                            jnp.asarray(base), steps=40,
                                            learning_rate=5e-3)
    ga, gt, gw = register_affine(_t(moving), _t(base), steps=40,
                                 learning_rate=5e-3)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), atol=1e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), atol=1e-3)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), atol=1e-3)


def test_fit_exit_wave_matches_emx():
    wave = make_wave(32, seed=4)
    dfs = np.asarray([-150.0, 0.0, 150.0], np.float32)
    stack = focal_series(wave, dfs).astype(np.float32)
    kw = dict(steps=15, learning_rate=0.05,
              fit_aberrations=("a20", "a22", "phi22"), fit_shifts=True)
    ref = flax_fit.fit_exit_wave(jnp.asarray(stack), jnp.asarray(dfs),
                                 flax_fit.AberrationFitConfig(**kw))
    got = fit_exit_wave(_t(stack), _t(dfs), AberrationFitConfig(**kw))
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-3)
    assert got["losses"][-1] < got["losses"][0]
    # Adam moves a pixel whose gradient is at float32 noise by up to lr a
    # step, either way: a few pixels drift by 1e-3 to 1e-2, the rest agree.
    diff = np.abs(got["exit_wave"].numpy() - np.asarray(ref["exit_wave"]))
    assert diff.max() < 1e-2 and diff.mean() < 1e-4, (diff.max(),
                                                      diff.mean())
