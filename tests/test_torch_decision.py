"""The port's decision path against emx's: the corpus families, the
defocus CTF, the ladders rebuilt from committed Poisson counts, and the
flagship decision's rows and policy.

Tolerances: the numpy families bit-identical; ctf images within 1e-5
(XLA's and torch's FFTs round differently); rebuilt noisy images
bit-identical and targets within 1e-5; PSNRs within 1e-3 dB (rows
round to 3 places)."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.bench import flagship_decision as emx_decision
from emx.data import pipeline as emx_pipeline
from emx.physics import ctf as emx_ctf
from emx_torch.bench import flagship_decision, ladders
from emx_torch.data import pipeline
from emx_torch.physics import ctf

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_port_ladders", ROOT / "scripts" / "make_port_ladders.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _script()


@pytest.mark.parametrize("name", ["synthetic_micrographs",
                                  "grain_micrographs",
                                  "filament_micrographs",
                                  "porous_micrographs"])
def test_numpy_family_is_bit_identical(name):
    ref = getattr(emx_pipeline, name)(3, 64, seed=5)
    got = getattr(pipeline, name)(3, 64, seed=5)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_ctf_family_matches_emx():
    ref = emx_pipeline.ctf_micrographs(3, 64, seed=5)
    got = pipeline.ctf_micrographs(3, 64, seed=5, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_defocus_ctf_matches_emx():
    np.testing.assert_array_equal(ctf.fftfreq(7).numpy(),
                                  np.asarray(jnp.fft.fftfreq(7)))
    kx, ky, k2 = ctf.spatial_frequencies((6, 5), (0.5, 2.0))
    for a, b in zip((kx, ky, k2),
                    emx_ctf.spatial_frequencies((6, 5), (0.5, 2.0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ref = np.asarray(emx_ctf.defocus_ctf(32, 2.51e-3, jnp.float32(5000.0),
                                         spher_aber_coeff=1e6))
    got = ctf.defocus_ctf(32, 2.51e-3, torch.tensor(5000.0),
                          spher_aber_coeff=1e6).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ladders.FAMILIES)
def test_rebuilt_ladder_matches_emx(script, family):
    """A cropped ladder (4 images of 64x64): emx's Poisson counts and the
    port's clean images give emx's noisy images and targets."""
    r = script.family_counts(family, n=4, size=64)
    clean = ladders.clean_images(family, 4, 64, device=CPU)
    np.testing.assert_allclose(ladders.fingerprint(clean).numpy(),
                               r["fingerprint"], rtol=0,
                               atol=ladders.FINGERPRINT_TOL)
    noisy, target = ladders.rebuild(clean, torch.from_numpy(r["counts"]))
    np.testing.assert_array_equal(noisy.numpy(), r["noisy"])
    np.testing.assert_allclose(target.numpy(), r["target"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        ladders.per_image_psnr(noisy, target).numpy(), r["identity_psnr"],
        rtol=0, atol=1e-3)


def _write_ladders(script, path, n=3, size=64, families=ladders.FAMILIES):
    arrays = {}
    for fam in families:
        r = script.family_counts(fam, n, size)
        arrays.update({f"{fam}_counts": r["counts"],
                       f"{fam}_doses": r["doses"],
                       f"{fam}_seed": np.int64(r["seed"]),
                       f"{fam}_key": np.int64(r["key"]),
                       f"{fam}_sha256": np.array(r["sha256"]),
                       f"{fam}_fingerprint": r["fingerprint"],
                       f"{fam}_identity_psnr": r["identity_psnr"]})
    np.savez_compressed(path, **arrays)
    return path


def test_ladder_file_guards(script, tmp_path):
    """The script's file loads; another family's fingerprint, a moved
    one or a wrong shape raises."""
    path = _write_ladders(script, tmp_path / "l.npz", families=("val",))
    noisy, target = ladders.val_ladder(CPU, str(path))
    assert noisy.shape == (3, 64, 64)
    with np.load(path) as z:
        good = dict(z)
    other = ladders.fingerprint(ladders.clean_images(
        "ood_grains", 3, 64, device=CPU)).numpy()
    for fp in (other, good["val_fingerprint"] + 2e-5):
        np.savez(tmp_path / "bad.npz", **dict(good, val_fingerprint=fp))
        with pytest.raises(ValueError, match="fingerprint"):
            ladders.val_ladder(CPU, str(tmp_path / "bad.npz"))
    bad = dict(good, val_counts=good["val_counts"][:2])
    np.savez(tmp_path / "short.npz", **bad)
    with pytest.raises(ValueError, match="shape"):
        ladders.val_ladder(CPU, str(tmp_path / "short.npz"))


def test_committed_ladder_file_matches_its_record():
    """Every family of the committed file: uint8 counts of (32, 512, 512),
    doses linspace(25, 150, 32), the seeds, a fingerprint per image."""
    with np.load(ROOT / ladders.LADDERS) as z:
        for fam in ladders.FAMILIES:
            assert z[f"{fam}_counts"].dtype == np.uint8
            assert z[f"{fam}_counts"].shape == (32, 512, 512)
            np.testing.assert_array_equal(
                z[f"{fam}_doses"],
                np.linspace(25.0, 150.0, 32).astype(np.float32))
            assert int(z[f"{fam}_seed"]) == ladders.SEEDS[fam]
            assert z[f"{fam}_identity_psnr"].shape == (32,)
            assert z[f"{fam}_fingerprint"].shape == (32, 3)


@pytest.mark.slow
def test_full_size_ladder_matches_emx(script):
    """The committed val ladder at full size against emx's _val_ladder:
    the same counts, the same clean images (sha256), the ladder."""
    r = script.family_counts("val")
    with np.load(ROOT / ladders.LADDERS) as z:
        np.testing.assert_array_equal(z["val_counts"], r["counts"])
        assert str(z["val_sha256"]) == r["sha256"]
    noisy, target = ladders.val_ladder(CPU, str(ROOT / ladders.LADDERS))
    np.testing.assert_array_equal(noisy.numpy(), r["noisy"])
    np.testing.assert_allclose(target.numpy(), r["target"], rtol=0,
                               atol=1e-5)


def test_family_rows_match_emx(script):
    """emx's family_rows and the port's on the same tiny ladders, with
    the same stand-in for the NN."""
    tiny = {f: script.family_counts(f, n=3, size=64)
            for f in ("val", "ood_ctf")}
    ref = emx_decision.family_rows(
        lambda x: 0.9 * x + 0.05,
        {f: (jnp.asarray(r["noisy"]), jnp.asarray(r["target"]))
         for f, r in tiny.items()})
    got = flagship_decision.family_rows(
        lambda x: 0.9 * x + 0.05,
        {f: (torch.tensor(r["noisy"]), torch.tensor(r["target"]))
         for f, r in tiny.items()})
    assert list(got) == list(ref)
    for f in ref:
        assert got[f]["best_classical"][0] == ref[f]["best_classical"][0]
        for k in ("nn_psnr", "margin", "identity_psnr"):
            assert abs(got[f][k] - ref[f][k]) <= 1.1e-3, (f, k)
        assert abs(got[f]["best_classical"][1]
                   - ref[f]["best_classical"][1]) <= 1.1e-3
    assert abs(flagship_decision.capped_margin_sum(got)
               - emx_decision.capped_margin_sum(ref)) <= 2.2e-3


def test_policy_matches_emx():
    def row(name, val, margins, rate):
        r = {"bundle": name, "img_per_s": rate}
        for f, m in zip(ladders.FAMILIES, margins):
            r[f] = {"nn_psnr": val if f == "val" else 30.0, "margin": m}
        return r

    rows = [row("a", 38.3, (2.3, 2.4, 3.0, 1.1, -1.5), 100.0),
            row("b", 38.5, (2.3, 2.4, 0.4, 1.1, -1.5), 100.0),
            row("c", 38.1, (2.3, 2.4, 3.0, 1.1, -1.45), 100.0),
            row("d", 35.0, (5.0, 5.0, 5.0, 5.0, 5.0), 100.0)]
    for gate, fams in ((36.0, ladders.FAMILIES), (36.0, ("val", "ood_ctf")),
                       (40.0, ladders.FAMILIES)):
        ref = emx_decision.select_winner(rows, gate, 50.0, families=fams)
        got = flagship_decision.select_winner(rows, gate, 50.0,
                                              families=fams)
        assert (got or {}).get("bundle") == (ref or {}).get("bundle")
    assert flagship_decision.capped_margin_sum(
        {f: rows[0][f] for f in ladders.FAMILIES}) == 2.5


def test_decision_never_writes_under_flagship(tmp_path):
    with pytest.raises(ValueError, match="never writes"):
        flagship_decision.main("docs/runs/flagship/sub", device="cpu")
