"""CPU rehearsal of chip_smoke.py's infilling-GAN and EWREC phases
(`gan`, `gan_quality`, `gan_demo`, `ewrec`) at tiny widths and sizes,
with their gates; a file of its own, so that the suite's workers run it
beside test_torch_chip_smoke.py. No JAX: these phases have no emx
counterpart to call (the parity tests are test_torch_{gan,infilling,
inpaint,recon}.py)."""

import json

import pytest
import torch

import chip_smoke

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


GAN_TINY = dict(steps=2, resume_steps=3, batch=2, crop=32, ckpt_every=1,
                scale=0.01)


def test_gan_phase(capsys):
    """train-infilling 2 steps and a resume to 3 through the CLI in
    subprocesses at a tiny width: every step logged with finite losses,
    both nets changed, the resumed state's digest the saved one's."""
    res = chip_smoke.phase_gan(CPU, chip_smoke.GanSmokeConfig(**GAN_TINY))
    first, second = res["first"], res["second"]
    assert (first["step"], second["start"], second["step"]) == (2, 2, 3)
    assert second["resumed"]["digest"] == first["digest"]
    assert first["changed"] == {"gen": True, "disc": True}
    out = capsys.readouterr().out
    assert "[gan] step 3: d_fake" in out and "img/s" in out


def test_gan_phase_checks_the_resume(monkeypatch):
    """A resumed state that differs from the saved one fails the phase."""
    real = chip_smoke._cli

    def tampered(*argv, **kw):
        out = real(*argv, **kw)
        rec = json.loads(out[-1])
        if rec["resumed"]:
            rec["resumed"]["digest"] = "0" * 64
        return out[:-1] + [json.dumps(rec)]

    monkeypatch.setattr(chip_smoke, "_cli", tampered)
    with pytest.raises(AssertionError, match="resumed"):
        chip_smoke.phase_gan(CPU, chip_smoke.GanSmokeConfig(**GAN_TINY))


@pytest.fixture(scope="module")
def tiny_gan_state(tmp_path_factory):
    """A tiny GAN state and its quality.json, as gan_quality.main writes
    them (2 steps, scale 0.01, 32x32, coverage 1/16)."""
    from emx_torch.bench import gan_quality

    out = tmp_path_factory.mktemp("gan_quality")
    gan_quality.main(str(out), steps=2, batch=2, size=32, scale=0.01,
                     mse_weight=100.0, coverage=16, corpus_size=4,
                     device="cpu")
    return str(out / "gan_state.npz"), str(out / "quality.json")


def test_gan_quality_phase(tiny_gan_state, capsys):
    """The eval-only call scores the state as its record has it (every
    row within the phase's gates), then 2 steps train from it."""
    state, record = tiny_gan_state
    res = chip_smoke.phase_gan_quality(CPU, chip_smoke.GanQualitySmokeConfig(
        state=state, record=record, batch=2, train_steps=2, corpus_size=4))
    assert res["scored"]["steps"] == 2 and res["trained"]["steps"] == 4
    out = capsys.readouterr().out
    assert "sha256" in out and "fingerprint" in out and "steps/s" in out


def test_gan_quality_phase_gates(tiny_gan_state, tmp_path):
    """A missing state fails the phase (it is not skipped), and so does a
    record the state does not reproduce."""
    state, record = tiny_gan_state
    with pytest.raises(FileNotFoundError):
        chip_smoke.phase_gan_quality(CPU, chip_smoke.GanQualitySmokeConfig(
            state=str(tmp_path / "absent.npz"), record=record))
    with open(record) as f:
        rec = json.load(f)
    rec["all"]["harmonic"] += 0.05
    bad = tmp_path / "quality.json"
    bad.write_text(json.dumps(rec))
    with pytest.raises(AssertionError, match="harmonic"):
        chip_smoke.phase_gan_quality(CPU, chip_smoke.GanQualitySmokeConfig(
            state=state, record=str(bad), batch=2, train_steps=1,
            corpus_size=4))


def test_gan_quality_config_is_the_committed_record():
    cfg = chip_smoke.GanQualitySmokeConfig()
    assert cfg.state == "docs/runs/gan_quality_300k/gan_state.npz"
    assert (cfg.nn_tol_db, cfg.classical_tol_db) == (0.10, 0.02)
    with open(cfg.record) as f:
        rec = json.load(f)
    assert rec["steps"] == 125000 and rec["all"]["nn"] == 25.784


def test_gan_demo_phase(capsys, monkeypatch):
    """gan_demo at 16x16, batch 2, with the tiny nets: a rollback after
    the simulated collapse, a forced switch, both nets trained."""
    from emx_torch.bench import gan_demo
    from emx_torch.nn.infilling import InfillingConfig

    monkeypatch.setattr(gan_demo, "SIZE", 16)
    monkeypatch.setattr(gan_demo, "BATCH", 2)
    monkeypatch.setattr(gan_demo, "NET", InfillingConfig.tiny())
    res = chip_smoke.phase_gan_demo(CPU, chip_smoke.GanDemoSmokeConfig())
    assert res["rollbacks"] >= 1 and res["forced_switches"] >= 1
    assert "[gan_demo]" in capsys.readouterr().out


def test_ewrec_phase(capsys):
    """The rates, the accuracy and diagnosis rows (not gated at this
    size) and the CLI on a 128x128 focal series of TIFFs: aligned, the
    defocus step found, complex |corr| above 0.95."""
    res = chip_smoke.phase_ewrec(CPU, chip_smoke.EwrecSmokeConfig(
        n_slices=5, rate_side=32, side=32, num_iter=5,
        check_records=False))
    assert res["cli_corr"] > 0.95
    assert res["rates"]["metric"] == "ewrec_iters_per_s"
    assert "defocus step" in capsys.readouterr().out


@pytest.mark.slow
def test_ewrec_phase_holds_the_records_on_the_cpu():
    """The full-size accuracy and diagnosis rows (15 slices, 256^2, 50
    GS iterations) against docs/runs/ewrec_r{4,5}_*.json, +-0.001, on
    the CPU (~1 min)."""
    chip_smoke.phase_ewrec(CPU, chip_smoke.EwrecSmokeConfig(
        rate_side=64, num_iter=50))
