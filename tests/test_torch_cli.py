"""`python -m emx_torch.cli harvest`, `train-denoiser`, `bench-train`,
`train-infilling` and `ewrec`
end to end on the CPU (`--device=cpu`, tiny widths), each against its
emx counterpart: harvest's census and manifest against emx's harvest
command on the same DM corpus; train-denoiser's directory artifact run
by emx and served by the port, and its resume; bench-train's rungs
against emx's ladder."""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from emx import cli as emx_cli
from emx.bench import train_bench as emx_train_bench
from emx.io.dm import write_dm as emx_write_dm
from emx.serve import export as emx_export
from emx_torch import cli
from emx_torch.bench import train_bench
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.serve.server import serve_artifact

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four 512x512 imaging micrographs, one 600x560, and a spectrum,
    an undersized and a truncated file to reject."""
    d = tmp_path_factory.mktemp("dm")
    for i, im in enumerate(synthetic_micrographs(4, 512, seed=1) * 800 + 40):
        emx_write_dm(str(d / f"m{i}.dm{3 + i % 2}"), im.astype(np.float32))
    emx_write_dm(str(d / "odd.dm4"), (RNG.random((600, 560)) * 60 + 5)
                 .astype(np.float32))
    emx_write_dm(str(d / "spec.dm3"), np.ones((512, 512), np.float32),
                 operation_mode="SPECTROSCOPY")
    emx_write_dm(str(d / "small.dm3"), np.ones((100, 100), np.float32))
    raw = (d / "m0.dm3").read_bytes()
    (d / "trunc.dm3").write_bytes(raw[:len(raw) // 2])
    return str(d)


@pytest.fixture(scope="module")
def harvested(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("harvested")
    cli.main(["harvest", f"--src={corpus}", f"--out={out}", "--size=64",
              "--device=cpu"])
    return str(out)


def test_cli_harvest_end_to_end(corpus, harvested, tmp_path, capsys):
    """The port's command and emx's on the same corpus: the same census
    line, five micrographs reaped, and manifests key for key with the
    stats within rtol 1e-3 / atol 1e-4 (float32 moments
    summed in other orders; a skewness near 0 differs by ~2e-5)."""
    cli.main(["harvest", f"--src={corpus}", f"--out={tmp_path / 'p'}",
              "--size=64", "--device=cpu"])
    ours = capsys.readouterr().out.splitlines()
    emx_cli.COMMANDS["harvest"]([f"--src={corpus}",
                                 f"--out={tmp_path / 'e'}", "--size=64"])
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0] == theirs[0] and "'usable': 5" in ours[0]
    assert ours[-1].split("->")[0] == theirs[-1].split("->")[0] == \
        "reaped 5 micrographs "
    a = [json.loads(x) for x in open(tmp_path / "p" / "manifest_0.jsonl")]
    b = [json.loads(x) for x in open(tmp_path / "e" / "manifest_0.jsonl")]
    assert [r["source"] for r in a] == [r["source"] for r in b]
    for r, e in zip(a, b):
        assert list(r) == list(e) and list(r["stats"]) == list(e["stats"])
        for k in e["stats"]:
            np.testing.assert_allclose(r["stats"][k], e["stats"][k],
                                       rtol=1e-3, atol=1e-4, err_msg=k)


def test_cli_train_denoiser_end_to_end(harvested, tmp_path, capsys):
    """train-denoiser at a tiny width on the harvested TIFFs: 4 steps
    with checkpoints every 2, then a second call to 6 that resumes from
    step 4 at its cursor; a finite loss; the directory artifact runs in
    emx within 1e-5 of the port's serve_artifact over HTTP."""
    run = str(tmp_path / "run")
    args = [f"--data_dir={harvested}", f"--model_dir={run}",
            "--batch_size=2", "--crop_size=32", "--scale=0.02",
            "--ckpt_every_steps=2", "--device=cpu"]
    cli.main(["train-denoiser", *args, "--steps=4"])
    first = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert first["step"] == 4 and np.isfinite(first["loss"])
    assert first["cursor"] == {"epoch": 1, "index": 4}   # 5 files, batch 2
    assert first["k2_launches"] == 0            # the CPU runs no kernel
    cli.main(["train-denoiser", *args, "--steps=6"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 4 at cursor {'epoch': 1, 'index': 4}"
    second = json.loads(out[-1])
    assert (second["start"], second["step"]) == (4, 6)
    assert second["cursor"] == {"epoch": 2, "index": 4}
    assert np.isfinite(second["loss"])

    x = RNG.random((1, 32, 32)).astype(np.float32)
    ref = np.asarray(emx_export.load_artifact(f"{run}/artifact")
                     .apply_fn()(x))
    srv = serve_artifact(f"{run}/artifact", tile=32, overlap=8, port=0,
                         device="cpu")
    try:
        buf = io.BytesIO()
        np.save(buf, x[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/predict",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            served = np.load(io.BytesIO(resp.read()), allow_pickle=False)
    finally:
        srv.stop()
    np.testing.assert_allclose(served, ref[0], rtol=0, atol=1e-5)


TINY_RUNG = dict(s2d=2, batch=2, dtype="f32", size=32, steps=2,
                 config_overrides=dict(features=(8, 8, 8, 8, 8),
                                       num_middle_blocks=1, aspp_filters=8,
                                       aspp_out=8))


def test_cli_bench_train_end_to_end(monkeypatch, capsys):
    """bench-train quick runs the quick rungs (here one tiny eager rung)
    and prints emx's keys per rung, and one more (steps_per_launch)."""
    monkeypatch.setattr(train_bench, "QUICK", [TINY_RUNG])
    cli.main(["bench-train", "quick", "--device=cpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    monkeypatch.setattr(emx_train_bench, "QUICK", [TINY_RUNG])
    emx_cli.COMMANDS["bench-train"](["quick"])
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(want) <= set(line) and line["device"] == "cpu"
    assert line["steps_per_launch"] == 1 and np.isfinite(line["loss"])
    assert {k: line[k] for k in ("s2d", "batch", "dtype", "norm")} == {
        k: want[k] for k in ("s2d", "batch", "dtype", "norm")}
    assert train_bench.LADDER[-1]["steps_per_launch"] == 8
    assert train_bench.LADDER[:-1] == emx_train_bench.LADDER


def test_cli_train_infilling_end_to_end(tmp_path, capsys):
    """`train-infilling` at a tiny width on the CPU: 2 steps with a
    checkpoint each step, then a second call resumes at step 2 with the
    saved state (equal digests) and trains to 3; every step logged."""
    from emx_torch.utils.metrics import read_jsonl

    args = [f"--model_dir={tmp_path}", "--batch_size=2", "--crop_size=32",
            "--scale=0.01", "--log_every=1", "--ckpt_every_steps=1",
            "--device=cpu"]
    outs = []
    for steps in (2, 3):
        cli.main(["train-infilling", f"--steps={steps}", *args])
        outs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    first, second = outs
    assert first["step"] == 2 and first["resumed"] is None
    assert first["changed"] == {"gen": True, "disc": True}
    assert second["resumed"] == {"step": 2, "digest": first["digest"]}
    assert second["step"] == 3 and second["digest"] != first["digest"]
    steps = [r["step"] for r in read_jsonl(str(tmp_path / "metrics.jsonl"))
             if "gen_loss" in r]
    assert steps == [1, 2, 3]


def test_cli_ewrec_end_to_end(tmp_path, capsys):
    """`ewrec` on the focal series of emx's tests/test_cli.py (three
    64x64 TIFFs): aligned, the defocus searched and the wave
    reconstructed as emx's command does (its functions, in process): the
    complex wave amplitude * exp(i phase) within 1e-3 (where the amplitude
    is near 0 the phase alone is ill-defined)."""
    import importlib

    import jax.numpy as jnp
    from emx.io.tiff import write_tiff
    from emx.physics.propagate import propagate_back_to_defocus
    from emx.recon import EWRECConfig, align_stack
    from emx_torch.io.tiff import read_tiff

    emx_ewrec = importlib.import_module("emx.recon.ewrec").ewrec
    wave = jnp.asarray(synthetic_micrographs(1, 64, seed=3)[0],
                       jnp.complex64)
    stack_dir = tmp_path / "stack"
    stack_dir.mkdir()
    imgs = []
    for i, df in enumerate([-150.0, 0.0, 150.0]):
        imgs.append(np.asarray(jnp.abs(
            propagate_back_to_defocus(wave, df, 0.025)) ** 2))
        write_tiff(str(stack_dir / f"img{i + 1}.tif"), imgs[-1])
    cli.main(["ewrec", f"--stack_dir={stack_dir}", "--num_iter=10",
              f"--out={tmp_path}/rec", "--device=cpu"])
    assert "loss:" in capsys.readouterr().out
    aligned, _ = align_stack(jnp.asarray(np.stack(imgs)))
    ref = emx_ewrec(aligned, EWRECConfig(wavelength=0.025, num_iter=10))
    amp = read_tiff(str(tmp_path / "rec" / "amplitude.tif"))
    phase = read_tiff(str(tmp_path / "rec" / "phase.tif"))
    np.testing.assert_allclose(amp, np.asarray(ref["amplitude"]), atol=1e-3)
    np.testing.assert_allclose(amp * np.exp(1j * phase),
                               np.asarray(ref["exit_wave"]), atol=1e-3)
