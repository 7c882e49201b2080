"""CPU rehearsal of chip_smoke.py's phases on tiny configs.

Every phase runs here with device="cpu", where the kernels' wrappers
take their plain versions: load, serve over HTTP (native, tiled), output
checks, the launch counts, the PSNR report, the fused-vs-int8
comparison, the K2 comparison and its bound, training with a checkpoint
and its restore, fold, calibrate, save and serve, and the report lines.
main() is not run: it must fail without a card, which test_device_phase_
needs_a_card checks."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import importlib.util
import pathlib
from emx.bench import flagship_decision as emx_decision
from emx.bench.quant_check import _psnr as emx_psnr
from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.serve import artifact as emx_artifact
from emx.serve.artifact import save_denoiser_artifact
from emx.serve.fused import dense_quantized_apply as emx_dense_apply
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.quantize import quantized_apply as emx_quantized_apply
from emx_torch.nn import DenoiserConfig


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers,
    and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    """A flagship-shaped tiny bundle (s2d 4, folded head, norm none,
    bf16, int8 mxu) and the smoke config that serves it on 64 tiles.
    Its weights are random, so the PSNR gain is reported, not gated."""
    cfg = dataclasses.replace(FlaxConfig.tiny(), norm="none",
                              space_to_depth=4, folded_head=16,
                              dtype=jnp.bfloat16)
    model = FlaxDenoiser(cfg)
    x = jnp.asarray(np.random.default_rng(0).random((2, 64, 64)),
                    jnp.float32)
    variables = model.init(jax.random.key(0), x, train=False)
    path = str(tmp_path_factory.mktemp("smoke") / "artifact_int8.npz")
    save_denoiser_artifact(path, cfg, variables, quant={
        "mode": "mxu", "amax": flax_calibrate(model, variables, [x])})
    return chip_smoke.SmokeConfig(
        bundle=path, tile=64, overlap=16, fused_rows=8, n_requests=2,
        big_shape=(100, 72), launches_per_forward=0, min_psnr_gain_db=None)


def test_serve_phase(tiny_config):
    res = chip_smoke.phase_serve(CPU, tiny_config)
    # 2 native forwards + ceil(4 windows / 8) tiled forward.
    assert res["forwards"] == 3 and res["launches"] == 0
    assert len(res["psnr_gain_db"]) == 2
    assert np.isfinite(res["psnr_gain_db"]).all()
    assert res["fused_vs_int8_psnr_db"] > 35.0
    assert res["forward_ms"] == {}          # timing needs the card


def test_serve_phase_checks_launches(tiny_config):
    cfg = dataclasses.replace(tiny_config, launches_per_forward=6)
    with pytest.raises(AssertionError, match="launched 0 times"):
        chip_smoke.phase_serve(CPU, cfg)


def test_kernel_phase_and_report_lines(capsys):
    shapes = (("tiny", 1, 16, 12, 20, 24), ("edge", 2, 8, 8, 8, 8))
    res = chip_smoke.phase_kernel(CPU, shapes=shapes)
    assert [r["name"] for r in res] == ["tiny", "edge"]
    assert all(r["max_abs_err"] == 0.0 for r in res)  # CPU: plain twice
    degrade = chip_smoke.phase_degrade(CPU, b=2, size=32)
    line = json.loads(json.dumps(chip_smoke.kernels_line(res, 7, degrade,
                                                         30)))
    k1, k2 = line["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms"}
    assert set(k1) == keys | {"b1", "phase_launches"} and set(k2) == keys
    assert k1["phase_launches"] == {"serve": 7}
    assert set(k1["b1"]) == set(chip_smoke.TIMED_KEYS)
    for k in (k1, k2):
        assert k["route"] == "cuda"
    assert k1["launches"] == 7 and k2["launches"] == 30
    assert k1["source"] == "emx_torch/csrc/sepconv.cu"
    assert k2["source"] == "emx_torch/csrc/degrade.cu"
    assert k2["replaces"] == "emx/ops/degrade_kernel.py:39"
    assert "[kernel] tiny" in capsys.readouterr().out


def test_bound_of_flagship_shapes():
    # folded.b: 8*128*128 px, 128 -> 128 channels. Bytes: bf16 in and
    # out plus f32 weights; it is bound by bytes at 3.35 TB/s.
    ms, by = chip_smoke.sepconv_bound_ms(8, 128, 128, 128, 128)
    px = 8 * 128 * 128
    nbytes = px * 128 * 2 * 2 + 4 * (9 * 128 + 128 + 128 * 128 + 128)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_request_data():
    rng = np.random.default_rng(0)
    clean = chip_smoke.smooth_field(rng, 64, 48)
    noisy, target = chip_smoke.degrade(rng, clean, 50.0)
    assert clean.shape == noisy.shape == target.shape == (64, 48)
    assert clean.min() == 0.0 and clean.max() == 1.0
    assert noisy.min() == 0.0 and noisy.max() == 1.0
    assert target.mean() == pytest.approx(noisy.mean(), rel=1e-5)


def test_device_phase_needs_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.phase_device(CPU)


def test_degrade_phase(capsys):
    res = chip_smoke.phase_degrade(CPU, b=2, size=48)
    # The training batch and five constant-rate images, all exact on the
    # CPU (the plain version twice); no timing without the card.
    assert len(res["checks"]) == 1 + len(chip_smoke.K2_RATES)
    assert res["max_abs_err"] == 0.0 and "ms" not in res
    assert "[degrade] constant@10.5" in capsys.readouterr().out


def test_degrade_bound():
    """At the training batch the bound is the bytes: 8 per element at
    3.35 TB/s; a rate-8 image's loop adds 5 operations per CDF term."""
    imgs = torch.full((16, 512, 512), 0.5)
    scales = torch.full((16,), 100.0)   # rate 50: the normal branch
    counts = torch.full_like(imgs, 50.0)
    ms, by = chip_smoke.degrade_bound_ms(imgs, scales, counts)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (8 * imgs.numel() + 64) / 3.35e12)
    small = torch.full((1, 2, 2), 8.0)
    ops = chip_smoke.degrade_ops(small, torch.tensor([[[0.0, 3.0],
                                                       [40.0, 8.0]]]))
    assert ops == 4 * 102 + 4 * 7 + 5 * (0 + 3 + 31 + 8)


TINY_TRAIN = chip_smoke.TrainSmokeConfig(
    model=dataclasses.replace(DenoiserConfig.tiny(), norm="batch",
                              dtype=torch.bfloat16, space_to_depth=4,
                              folded_head=16, remat_middle=True),
    n_images=8, size=64, batch=4, steps=8, window=3, k2_per_step=0)


@pytest.fixture(scope="module")
def trained():
    return chip_smoke.phase_train(CPU, TINY_TRAIN)


def test_train_phase(trained):
    """The flagship-shaped tiny model trains 8 steps through Trainer.fit:
    finite, falling loss; the halfway checkpoint restores exactly (the
    phase raises otherwise); no K2 launch on the CPU."""
    assert len(trained["losses"]) == 8 and trained["launches"] == 0
    assert np.isfinite(trained["losses"]).all()
    assert trained["peak_bytes"] == 0 and trained["step_ms"] > 0


def test_train_phase_checks_launches():
    cfg = dataclasses.replace(TINY_TRAIN, k2_per_step=1)
    with pytest.raises(AssertionError, match="K2 launched 0 times"):
        chip_smoke.phase_train(CPU, cfg)


def test_deploy_phase(trained):
    """Fold, calibrate, save and serve the trained tiny model."""
    res = chip_smoke.phase_deploy(CPU, trained, chip_smoke.DeploySmokeConfig(
        fused_rows=8, launches_per_forward=0))
    assert res["fold_psnr_db"] > 35.0 and res["launches"] == 0
    assert res["n_amax"] > 0 and np.isfinite(res["psnr_gain_db"])
    with pytest.raises(AssertionError, match="K1 launched 0 times"):
        chip_smoke.phase_deploy(CPU, trained, chip_smoke.DeploySmokeConfig(
            fused_rows=8))


def test_flagship_training_config():
    cfg = chip_smoke.TrainSmokeConfig()
    m = cfg.model
    assert (m.norm, m.dtype, m.space_to_depth, m.folded_head,
            m.remat_middle) == ("batch", torch.bfloat16, 4, 128, True)
    assert m.features == (64, 128, 256, 728, 728)
    assert (m.num_middle_blocks, m.aspp_filters, m.aspp_out) == (11, 728, 256)
    assert (cfg.batch, cfg.size, cfg.learning_rate) == (16, 512, 1e-3)


ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny_ladders(tmp_path_factory):
    """The five ladders at 2 images of 64x64, written by the script that
    writes the committed file (emx draws the counts)."""
    spec = importlib.util.spec_from_file_location(
        "make_port_ladders", ROOT / "scripts" / "make_port_ladders.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    path = str(tmp_path_factory.mktemp("ladders") / "ladders.npz")
    script.main(path, n=2, size=64)
    return path


@pytest.fixture(scope="module")
def tiny_decision(tiny_config, tiny_ladders, tmp_path_factory):
    """The decision and variants phases' config on the tiny bundle and
    ladders, held to references that emx computes here as it computed
    DECISION.json and serve_perf.json: its unfused int8 graph's rows on
    the five ladders, and the variants' val PSNR."""
    cfg, variables, quant = emx_artifact.load_denoiser_artifact(
        tiny_config.bundle, with_quant=True)
    model, skip = FlaxDenoiser(cfg), quant.get("skip", ())
    ladders = {}
    for fam in chip_smoke.FAMILIES:
        noisy, clean = chip_smoke.load_ladder(fam, CPU, tiny_ladders)
        ladders[fam] = (jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy()))
    rows = emx_decision.family_rows(jax.jit(emx_quantized_apply(
        model, variables, quant["amax"], quant["mode"], skip=skip)), ladders)
    out = tmp_path_factory.mktemp("references")
    (out / "DECISION.json").write_text(json.dumps({
        "candidates": [{"sha256": chip_smoke.file_sha256(tiny_config.bundle),
                        **rows}],
        "winner_capped_margin_sum": emx_decision.capped_margin_sum(rows)}))
    graphs = {"mxu2/out_float32/b96": emx_quantized_apply(
        model, variables, quant["amax"], "mxu2", skip=skip)}
    for kind in ("int8", "bf16"):
        graphs[f"mxu/dense_{kind}/b96"] = emx_dense_apply(
            model, variables, quant["amax"], quant["mode"], skip=skip,
            quantized=kind == "int8")
    noisy, clean = ladders["val"]
    (out / "serve_perf.json").write_text(json.dumps({"rows": [
        {"variant": tag, "psnr": emx_psnr(jax.jit(fn)(noisy), clean)}
        for tag, fn in graphs.items()]}))
    return chip_smoke.DecisionSmokeConfig(
        bundle=tiny_config.bundle, ladders=tiny_ladders, fused_rows=8,
        reference=str(out / "DECISION.json"),
        serve_perf=str(out / "serve_perf.json"))


def test_decision_phase(tiny_decision, tmp_path):
    """Both graphs, the filters and identity on the five tiny ladders,
    held at the phase's tolerances to emx's rows; then, with one NN PSNR
    of the reference moved 0.06 dB from the port's, the 0.05 dB gate
    fails."""
    assert tiny_decision.psnr_tol_db == 0.05
    res = chip_smoke.phase_decision(CPU, tiny_decision)
    assert set(res["rows"]["unfused"]) == set(chip_smoke.FAMILIES)
    assert res["launches"] == 0 and res["img_per_s"] == {}
    with open(tiny_decision.reference) as f:
        dec = json.load(f)
    row = dec["candidates"][0]
    row["ood_porous"]["nn_psnr"] = round(
        res["rows"]["unfused"]["ood_porous"]["nn_psnr"] + 0.06, 3)
    path = tmp_path / "DECISION.json"
    path.write_text(json.dumps(dec))
    cfg = dataclasses.replace(tiny_decision, reference=str(path))
    with pytest.raises(AssertionError, match="ood_porous unfused nn"):
        chip_smoke.phase_decision(CPU, cfg)


def test_variants_phase(tiny_decision):
    res = chip_smoke.phase_variants(CPU, tiny_decision)
    assert [t for t, _ in chip_smoke.VARIANTS] == list(res)
    assert all(np.isfinite(r["psnr"]) and r["img_per_s"] is None
               for r in res.values())


def test_variants_reference_tags():
    """The tags chip_smoke holds are rows of serve_perf.json."""
    with open(ROOT / chip_smoke.SERVE_PERF_JSON) as f:
        tags = {r["variant"] for r in json.load(f)["rows"]}
    assert {t for t, _ in chip_smoke.VARIANTS} <= tags


def test_decision_reference_of_the_flagship():
    ref = chip_smoke.decision_reference(chip_smoke.DecisionSmokeConfig()
                                        .bundle)
    assert ref["capped_margin_sum"] == 2.544
    assert ref["rows"]["val"]["nn_psnr"] == 38.326
    assert ref["rows"]["ood_porous"]["best_classical"][0] == "median"


def test_auto_phase(tiny_config, tiny_ladders):
    res = chip_smoke.phase_auto(CPU, chip_smoke.AutoSmokeConfig(
        bundle=tiny_config.bundle, ladders=tiny_ladders, fused_rows=8,
        tile=64, overlap=16, big_shape=(100, 72)))
    assert sum(res["chosen"].values()) == len(chip_smoke.FAMILIES)
    assert sum(res["val_chosen"].values()) == 2 and res["launches"] == 0


def test_export_phase(tiny_config):
    res = chip_smoke.phase_export(CPU, chip_smoke.ExportSmokeConfig(
        bundle=tiny_config.bundle, size=64))
    assert res["err_dir"] <= chip_smoke.BF16_STEP
    assert res["err_export"] <= chip_smoke.BF16_STEP


def test_kernel_phase_checks_every_serving_batch():
    """phase_kernel holds K1 to its plain version at every batch the
    smoke's paths give it: B=8 and 1 (serve), one ladder (decision,
    auto) and the serving-rate batch."""
    import inspect
    shapes = inspect.signature(chip_smoke.phase_kernel).parameters[
        "shapes"].default
    with np.load(ROOT / chip_smoke.LADDERS) as z:
        ladder_batch = z["val_counts"].shape[0]
    assert chip_smoke.LADDER_BATCH == ladder_batch
    assert chip_smoke.DecisionSmokeConfig().rate_batch == chip_smoke.RATE_BATCH
    for batch in (8, 1, ladder_batch, chip_smoke.RATE_BATCH):
        got = {tuple(s[2:]) for s in shapes if s[1] == batch}
        assert got >= {tuple(b[1:]) for b in chip_smoke.FLAGSHIP_BLOCKS}


@pytest.mark.parametrize("kw, mode", [({}, "mxu"), ({"mode": "mxu2"}, "mxu2"),
                                      ({"dense": "bf16"}, "mxu"),
                                      ({"out_dtype": "bfloat16"}, "mxu")])
def test_bundle_graph_variants(tiny_config, kw, mode):
    fn, got = chip_smoke.bundle_graph(tiny_config.bundle, CPU, **kw)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 64), dtype=np.float32))
    out = fn(x)
    assert got == mode and out.shape == x.shape
    assert bool(torch.isfinite(out.float()).all())
    assert out.dtype == (torch.bfloat16 if kw.get("out_dtype")
                         else torch.float32)


@pytest.fixture
def on_tiny_ladders(tiny_ladders, monkeypatch):
    """The bench tools read the ladder file's module path: the tiny
    ladders stand in for the committed ones."""
    from emx_torch.bench import ladders
    monkeypatch.setattr(ladders, "LADDERS", tiny_ladders)


def test_quality_phase(on_tiny_ladders, monkeypatch):
    """The quality phase on a tiny width at 64x64: two steps, a resumed
    third, emx's record keys, the fold within 0.05 dB, the bundle
    served; no K2 launch on the CPU."""
    monkeypatch.setattr(chip_smoke.quality_run, "MODEL",
                        DenoiserConfig.tiny())
    monkeypatch.setattr(chip_smoke.quality_run, "SIZE", 64)
    cfg = chip_smoke.QualitySmokeConfig(steps=2, resume_steps=3, batch=2,
                                        folded_head=16, corpus_size=8,
                                        k2_per_step=0)
    res = chip_smoke.phase_quality(CPU, cfg)
    assert res["launches"] == 0
    assert (res["first"]["steps"], res["second"]["steps"]) == (2, 3)
    with pytest.raises(AssertionError, match="K2 launched 0 times"):
        chip_smoke.phase_quality(CPU, dataclasses.replace(cfg,
                                                          k2_per_step=1))


def test_quality_smoke_config_is_the_flagship_recipe():
    cfg = chip_smoke.QualitySmokeConfig()
    with open(ROOT / chip_smoke.QUALITY_JSON) as f:
        rec = json.load(f)
    assert (cfg.s2d, cfg.norm, cfg.folded_head, cfg.batch, cfg.corpus) == (
        rec["s2d"], rec["norm"], rec["folded_head"], rec["batch"],
        rec["corpus"])
    assert int(0.7 * cfg.steps) == 14 and cfg.resume_steps > cfg.steps
    q = chip_smoke.QatSmokeConfig()
    with open(ROOT / "docs/runs/qat_r5/qat_tail_decoder2.json") as f:
        rec = json.load(f)
    assert (q.scope, q.corpus, q.batch, q.lr, q.mode) == (
        rec["scope"], rec["corpus"], rec["batch"], rec["lr"], rec["mode"])


@pytest.fixture(scope="module")
def tiny_qat_bundle(tiny_config, tiny_ladders, tmp_path_factory):
    """The tiny bundle with the record a QAT bundle carries, computed by
    emx on the tiny val ladder: its float PSNR and its int8 mxu PSNR
    after calibrating on the ladder's first 8 inputs."""
    cfg, variables, quant = emx_artifact.load_denoiser_artifact(
        tiny_config.bundle, with_quant=True)
    model = FlaxDenoiser(cfg)
    noisy, clean = chip_smoke.load_ladder("val", CPU, tiny_ladders)
    nj, cj = jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy())
    amax = flax_calibrate(model, variables, [nj[:8]])
    path = str(tmp_path_factory.mktemp("qat") / "artifact_int8.npz")
    save_denoiser_artifact(path, cfg, variables, quant={
        "mode": "mxu", "amax": amax,
        "float_psnr": emx_psnr(model.apply(variables, nj), cj),
        "psnr": emx_psnr(jax.jit(emx_quantized_apply(
            model, variables, amax, "mxu"))(nj), cj)})
    return path


TINY_QAT = dict(steps=4, batch=2, corpus_size=4, log_every=2, fused_rows=8,
                float_steps=2, k2_per_step=0, k1_per_forward=0)


def test_qat_phase(tiny_qat_bundle, on_tiny_ladders):
    """The qat phase on the tiny bundle: float and PTQ PSNR at emx's
    record (0.05 dB), the tail against the int8 graph above 35 dB
    before and after, the candidate unfused against fused, the
    full-model float finetune."""
    cfg = chip_smoke.QatSmokeConfig(bundle=tiny_qat_bundle, **TINY_QAT)
    res = chip_smoke.phase_qat(CPU, cfg)
    assert res["k1_launches"] == 0 and res["k2_launches"] == 0
    assert len(res["distill"]["loss_trace"]) == 2
    assert set(res["rows"]["fused"]) == set(chip_smoke.FAMILIES)


def test_qat_phase_holds_the_bundle_record(tiny_qat_bundle, on_tiny_ladders,
                                           tmp_path):
    """With the bundle's recorded float PSNR moved 0.06 dB from what
    the port measures, the 0.05 dB gate fails."""
    cfg, flat, quant = chip_smoke.read_artifact(tiny_qat_bundle)
    quant["float_psnr"] = round(quant["float_psnr"] + 0.06, 3)
    path = str(tmp_path / "moved.npz")
    chip_smoke.save_denoiser_artifact(path, cfg, {"params": flat},
                                      quant=quant)
    qcfg = chip_smoke.QatSmokeConfig(bundle=path, **TINY_QAT)
    with pytest.raises(AssertionError, match="float psnr"):
        chip_smoke.phase_qat(CPU, qcfg)


def test_kernels_line_counts_k2_phases():
    phases = {"train": 30, "graph": 75, "files": 24, "quality": 24,
              "qat": 311}
    line = chip_smoke.kernels_line(
        [{"max_abs_err": 0.0}], 7, {"max_abs_err": 0.0}, 30, {"serve": 7},
        phases)
    k1, k2 = line["kernels"]
    assert k2["phase_launches"] == phases
    assert k2["launches"] == 30 and k1["phase_launches"] == {"serve": 7}


GRAPH_TINY = dict(n_images=8, size=32, batch=2, k=2, pre_steps=1)


def test_graph_phase_needs_the_card():
    """The graph phase runs its eager steps on the CPU, then refuses: a
    CUDA graph needs the card."""
    cfg = chip_smoke.GraphSmokeConfig(
        model=dataclasses.replace(DenoiserConfig.tiny(), norm="batch"),
        **GRAPH_TINY)
    with pytest.raises(RuntimeError, match="CUDA card"):
        chip_smoke.phase_graph(CPU, cfg)


FILES_TINY = dict(n_micrographs=3, size=512, odd_shape=(600, 560),
                  harvest_size=64, batch=2, crop=32, steps=4, resume_steps=6,
                  steps_per_launch=1, ckpt_every=2, scale=0.02,
                  request_shapes=((32, 32), (600, 530)), loader_batches=2)


def test_files_phase(capsys):
    """The files phase on the CPU at a tiny width and 64x64 harvest:
    harvest's census (7 files, 3 rejected), train-denoiser 4 steps and a
    resume to 6 through the CLI in subprocesses, the artifact served at
    a native and a tiled shape."""
    res = chip_smoke.phase_files(CPU, chip_smoke.FilesSmokeConfig(
        **FILES_TINY))
    assert res["census"] == {"total": 7, "decode_failed": 1,
                             "not_imaging": 1, "too_small": 1,
                             "too_dim": 0, "usable": 4}
    first, second = res["train"]
    assert (first["step"], second["start"], second["step"]) == (4, 4, 6)
    assert res["launches"] == 0          # no kernel runs on the CPU
    assert "served 2 requests" in capsys.readouterr().out


def test_files_phase_checks_the_resume(monkeypatch):
    """A resume that does not come back at the saved step fails."""
    real = chip_smoke._cli

    def no_resume(*argv):
        out = real(*argv)
        return [ln for ln in out if not ln.startswith("resumed")] or out

    monkeypatch.setattr(chip_smoke, "_cli", no_resume)
    with pytest.raises(AssertionError, match="resumed"):
        chip_smoke.phase_files(CPU, chip_smoke.FilesSmokeConfig(
            **FILES_TINY))

