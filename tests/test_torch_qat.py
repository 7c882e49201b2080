"""The slice's training-side modules against emx's on the CPU: the mixed
corpora, fake_quant_apply (forward and parameter gradients, modes
store/mxu/mxu2), one tail-distillation step with Adam, the bench tools
end to end on a tiny bundle and tiny ladders, and the CLI."""

import dataclasses
import importlib.util
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import emx.cli as emx_cli
from emx.data.pipeline import mixed_micrographs as emx_mixed
from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.nn.denoiser import FoldedHeadTail as FlaxTail
from emx.nn.denoiser import tail_param_names as flax_tail_names
from emx.serve.artifact import save_denoiser_artifact
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.quantize import fake_quant_apply as flax_fake_quant
from emx.serve.quantize import quantized_apply as flax_quantized
from emx.train.losses import huberised_mse as flax_huber
from emx_torch import cli
from emx_torch.bench import ladders as port_ladders
from emx_torch.bench import qat_finetune, quality_run, quant_check
from emx_torch.data.pipeline import mixed_micrographs
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.nn.denoiser import FoldedHeadTail
from emx_torch.serve.convert import _tensors, load_flax_params, to_flax_params
from emx_torch.serve.quantize import (FakeQuantConv, _scale_of, calibrate,
                                      fake_quant_apply, quantized_apply)
from emx_torch.train.losses import huberised_mse

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("grains, filaments", [(True, False), (True, True),
                                               (False, False)])
def test_mixed_micrographs_match_emx(grains, filaments):
    """The same composition, seeds and shuffle: every image but the ctf
    ones bit for bit; the ctf ones render on torch.fft, within 1e-5 of
    XLA's render."""
    n, size = 8, 32
    ref = emx_mixed(n, size, seed=3, grains=grains, filaments=filaments)
    got = mixed_micrographs(n, size, seed=3, grains=grains,
                            filaments=filaments, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    err = np.abs(got - ref).reshape(n, -1).max(axis=1)
    assert err.max() < 1e-5, err
    assert (err == 0).sum() >= n - n // 4


# A tiny norm-free folded-head model in float32: conv sums run in other
# orders in XLA and torch, so a value within rounding of an int8 grid
# midpoint may take the neighbouring level on one side.
KW = dict(norm="none", space_to_depth=2, folded_head=16,
          num_middle_blocks=0)


@pytest.fixture(scope="module")
def tiny():
    x = np.random.default_rng(0).random((2, 32, 32)).astype(np.float32)
    model = FlaxDenoiser(dataclasses.replace(FlaxConfig.tiny(), **KW))
    variables = model.init(jax.random.key(1), jnp.asarray(x), train=False)
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    target = (np.random.default_rng(7).random(x.shape) * 0.5
              + 0.25).astype(np.float32)
    return x, model, variables, amax, target


def _port(variables):
    return load_flax_params(
        Denoiser(dataclasses.replace(DenoiserConfig.tiny(), **KW),
                 device="cpu"), _flat(variables["params"]))


def _grads_flax(model) -> dict:
    """The .grad of every parameter of `model`, in flax's layouts."""
    out = {}
    for _, key, t, _, change_out in _tensors(model):
        if t.grad is not None:
            g = t.grad.numpy()
            out[key] = np.ascontiguousarray(change_out(g) if change_out
                                            else g)
    return out


# Gradient tolerance per parameter, relative to its norm: in 'store'
# only float32 sums differ; with weights on the int8 grid a weight or
# activation within rounding of a grid midpoint takes the neighbouring
# level on one side, which moves small gradients by up to ~1%.
GRAD_TOL = {"store": 1e-5, "mxu": 3e-2, "mxu2": 3e-2}


@pytest.mark.parametrize("mode", ["store", "mxu", "mxu2"])
def test_fake_quant_forward_and_gradients_match_emx(tiny, mode):
    """fake_quant_apply's output and the gradient of a mean squared
    error with respect to every parameter, against emx's jax.grad."""
    x, model, variables, amax, target = tiny
    fq = flax_fake_quant(model, amax, mode)

    def loss_fn(p):
        return jnp.mean((fq({"params": p}, jnp.asarray(x)) - target) ** 2)

    ref_out = np.asarray(fq(variables, jnp.asarray(x)))
    ref_g = _flat(jax.jit(jax.grad(loss_fn))(variables["params"]))

    port = _port(variables)
    pfq = fake_quant_apply(port, amax, mode)
    out = pfq(port, torch.from_numpy(x))
    torch.mean((out - torch.from_numpy(target)) ** 2).backward()
    got_g = _grads_flax(port)

    err = np.abs(out.detach().numpy() - ref_out)
    assert err.mean() < 1e-5 and err.max() < 1e-3, (err.mean(), err.max())
    assert set(got_g) == set(ref_g)
    for k, g in ref_g.items():
        scale = max(np.linalg.norm(g), 1e-12)
        assert np.linalg.norm(got_g[k] - g) / scale < GRAD_TOL[mode], k
    assert max(np.linalg.norm(g) for g in got_g.values()) > 0


@pytest.mark.parametrize("mode", ["store", "mxu", "mxu2"])
def test_fake_quant_agrees_with_quantized_apply(tiny, mode):
    """The STE twin reproduces the port's int8 graph's forward within
    accumulation tolerance (emx's test_fake_quant_matches_quantized_
    forward_and_is_trainable: mean error below 2e-3)."""
    x, _, variables, amax, _ = tiny
    port = _port(variables).eval()
    got_q = quantized_apply(port, amax, mode)(torch.from_numpy(x))
    with torch.no_grad():
        got_f = fake_quant_apply(port, amax, mode)(port,
                                                   torch.from_numpy(x))
    assert float((got_q - got_f).abs().mean()) < 2e-3


def test_fake_quant_is_trainable(tiny):
    """Descending the fake-quant loss moves the real int8 graph toward
    the target (emx's trainability check, with torch's Adam)."""
    x, _, variables, amax, target = tiny
    port = _port(variables)
    fq = fake_quant_apply(port, amax, "mxu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)

    def q_loss():
        return float(torch.mean((quantized_apply(port, amax, "mxu")(xt)
                                 - tt) ** 2))

    before = q_loss()
    opt = qat_finetune.adam(port.parameters(), 1e-3)
    for _ in range(30):
        opt.zero_grad()
        torch.mean((fq(port, xt) - tt) ** 2).backward()
        opt.step()
    assert q_loss() < before


def test_fake_quant_takes_a_parameter_mapping(tiny):
    x, _, variables, amax, _ = tiny
    port = _port(variables)
    fq = fake_quant_apply(port, amax, "mxu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        same = fq(dict(port.named_parameters()), xt)
        assert torch.equal(same, fq(port, xt))
        zeroed = {"ConvBlock_0.Conv_0.bias": torch.full_like(
            port.ConvBlock_0.Conv_0.bias, 0.5)}
        assert not torch.equal(fq(zeroed, xt), same)
    assert float(port.ConvBlock_0.Conv_0.bias.detach().abs().sum()) == 0.0
    with pytest.raises(TypeError):
        fq(_port(variables), xt)
    with pytest.raises(ValueError, match="mode"):
        fake_quant_apply(port, amax, "int4")


def test_fake_quant_skip_and_depthwise_guard(tiny):
    """`skip` and an uncalibrated conv stay float; in mxu a depthwise
    conv gets the input round-trip only, in mxu2 its weight too."""
    x, _, variables, amax, _ = tiny
    port = _port(variables)
    for path, modes in (("SepConvBlock_0/Conv_0", ("mxu2",)),
                        ("SepConvBlock_0/Conv_1", ("mxu", "mxu2"))):
        conv = port.get_submodule(path.replace("/", "."))
        for mode in ("store", "mxu", "mxu2"):
            fq = FakeQuantConv(conv, _scale_of(amax[path]), mode)
            assert fq.int8_weight == (mode in modes), (path, mode)
            assert fq.weight is conv.weight and fq.path == path
    # Skipping every conv leaves the float model's output.
    fq = fake_quant_apply(port, amax, "mxu", skip=list(amax))
    with torch.no_grad():
        assert torch.equal(fq(port, torch.from_numpy(x)),
                           port(torch.from_numpy(x)))


# ---- one tail-distillation step against emx's -------------------------

TAIL_KW = dict(norm="none", space_to_depth=4, folded_head=16)


def test_tail_step_matches_emx():
    """Same captured features, targets and tail parameters: the fake-
    quant tail's huberised loss and one Adam update (optax.adam against
    torch.optim.Adam with optax's defaults) agree with emx's."""
    x = np.random.default_rng(2).random((2, 64, 64)).astype(np.float32)
    model = FlaxDenoiser(dataclasses.replace(FlaxConfig.tiny(), **TAIL_KW))
    variables = model.init(jax.random.key(3), jnp.asarray(x), train=False)
    amax, order = flax_calibrate(model, variables, [jnp.asarray(x)],
                                 return_order=True)
    scope = "decoder2"
    mapping = flax_tail_names(order, 2, scope)
    caps = qat_finetune.capture_points(order, mapping, scope)
    _, (cat1, cat2) = jax.jit(flax_quantized(model, variables, amax, "mxu",
                                             capture=caps))(jnp.asarray(x))
    f2 = model.config.features[2]
    cat = (cat1, cat2[..., f2:], jnp.asarray(x))
    tgt = (np.random.default_rng(4).random(x.shape) * 0.5
           + 0.25).astype(np.float32)
    lr = 1e-3

    tail = FlaxTail(model.config, tail_scope=scope)
    tp = {new: variables["params"][old] for old, new in mapping.items()}
    tail_amax = flax_calibrate(tail, {"params": tp}, [cat])
    fq = flax_fake_quant(tail, tail_amax, "mxu")

    def loss_fn(p):
        return flax_huber(fq({"params": p}, cat).astype(jnp.float32),
                          jnp.asarray(tgt))

    opt = optax.adam(lr)
    ref_loss, g = jax.jit(jax.value_and_grad(loss_fn))(tp)
    updates, _ = opt.update(g, opt.init(tp))
    ref_new = _flat(optax.apply_updates(tp, updates))

    tcfg = dataclasses.replace(DenoiserConfig.tiny(), **TAIL_KW)
    ptail = load_flax_params(FoldedHeadTail(tcfg, scope, device="cpu"),
                             _flat(tp))
    pcat = tuple(torch.from_numpy(np.array(a)) for a in cat)
    p_amax = calibrate(ptail, [pcat])
    pfq = fake_quant_apply(ptail, p_amax, "mxu")
    popt = qat_finetune.adam(ptail.parameters(), lr)
    loss = huberised_mse(pfq(ptail, pcat).float(), torch.from_numpy(tgt))
    loss.backward()
    popt.step()
    got_new = to_flax_params(ptail)[0]

    assert abs(float(loss.detach()) - float(ref_loss)) \
        < 1e-4 * abs(float(ref_loss))
    assert set(got_new) == set(ref_new)
    # Adam's first step moves each element by ~lr * sign(g): compare the
    # steps, not the parameters; an element whose gradient is within
    # eps of zero may step otherwise, so a bound on the share.
    worst = []
    for k, new in ref_new.items():
        old = _flat(tp)[k]
        step_ref, step_got = new - old, got_new[k] - old
        bad = np.abs(step_got - step_ref) > 0.05 * lr
        worst.append(bad.mean())
    assert max(worst) < 0.01, max(worst)


# ---- the bench tools end to end on a tiny bundle ----------------------

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


@pytest.fixture
def on_tiny_ladders(tiny_ladders, monkeypatch):
    monkeypatch.setattr(port_ladders, "LADDERS", tiny_ladders)
    return tiny_ladders


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    """A flagship-shaped tiny bundle (s2d 4, folded head, norm none,
    bf16, int8 mxu) written by emx."""
    cfg = dataclasses.replace(FlaxConfig.tiny(), dtype=jnp.bfloat16,
                              **TAIL_KW)
    model = FlaxDenoiser(cfg)
    x = jnp.asarray(np.random.default_rng(0).random((2, 64, 64)),
                    jnp.float32)
    variables = model.init(jax.random.key(0), x, train=False)
    path = str(tmp_path_factory.mktemp("bundle") / "artifact_int8.npz")
    save_denoiser_artifact(path, cfg, variables, quant={
        "mode": "mxu", "amax": flax_calibrate(model, variables, [x])})
    return path, model, variables


def _emx_keys(path):
    with open(ROOT / path) as f:
        return set(json.load(f))


def test_head_distill_end_to_end(tiny_bundle, on_tiny_ladders, tmp_path):
    """Two steps of tail distillation on the tiny bundle: emx's record
    keys (docs/runs/qat_r5/qat_tail_decoder2.json) plus the port's
    `tail_int8_psnr`; the float and PTQ PSNRs equal emx's on the same
    ladder; the candidate reloads with emx's quant keys."""
    bundle, model, variables = tiny_bundle
    out = qat_finetune.head_distill(
        bundle, str(tmp_path), steps=2, batch=2, lr=5e-5, psnr_gate=0.0,
        scope="decoder2", corpus="mixed3", corpus_size=4, log_every=1,
        device="cpu")
    assert set(out) - _emx_keys("docs/runs/qat_r5/qat_tail_decoder2.json") \
        == {"tail_int8_psnr"}
    assert _emx_keys("docs/runs/qat_r5/qat_tail_decoder2.json") <= set(out)
    assert len(out["loss_trace"]) == 2 and out["qat_img_per_s"] is None
    assert min(out["tail_int8_psnr"].values()) > 35.0
    with open(tmp_path / "qat_tail_decoder2.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    # emx's float and PTQ scores on the same (tiny) val ladder.
    noisy, clean = port_ladders.val_ladder(CPU)
    nj, cj = jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy())
    from emx.bench.quant_check import _psnr as emx_psnr
    ref_float = emx_psnr(model.apply(variables, nj, train=False), cj)
    amax = flax_calibrate(model, variables, [nj[:8]])
    ref_ptq = emx_psnr(flax_quantized(model, variables, amax, "mxu")(nj), cj)
    assert abs(out["float_psnr"] - ref_float) <= 0.01
    assert abs(out["ptq_psnr"] - ref_ptq) <= 0.05
    from emx.serve.artifact import load_denoiser_artifact
    _, _, q = load_denoiser_artifact(out["candidate_bundle"],
                                     with_quant=True)
    assert q["qat"]["scope"] == "decoder2" and q["mode"] == "mxu"
    assert set(q["qat"]["head_modules"]) == set(out["head_modules"])


@pytest.mark.parametrize("kw, name", [
    (dict(target="float", clean_weight=0.5), "qat_float.json"),
    (dict(trainable_last_n=3), "qat.json")])
def test_qat_main_end_to_end(tiny_bundle, on_tiny_ladders, tmp_path, kw,
                             name):
    bundle, _, _ = tiny_bundle
    out = qat_finetune.main(bundle, str(tmp_path), steps=2, batch=2,
                            psnr_gate=0.0, corpus_size=4, log_every=1,
                            device="cpu", **kw)
    # emx's keys (emx/bench/qat_finetune.py:40-207) and the port's one.
    keys = {"metric", "artifact", "mode", "steps", "batch", "lr", "target",
            "clean_weight", "float_psnr", "ptq_psnr", "train_s",
            "loss_trace", "qat_psnr", "qat_float_psnr", "qat_img_per_s",
            "psnr_gate", "incumbent_psnr", "gate_passed", "promoted"}
    if "trainable_last_n" in kw:
        keys.add("trainable_tops")
        assert len(out["trainable_tops"]) <= 3
    assert set(out) == keys | {"fq_int8_psnr"}
    assert out["fq_int8_psnr"] > 35.0 and len(out["loss_trace"]) == 2
    assert (tmp_path / name).exists()


def test_quant_check_tools_match_emx(tiny_bundle, on_tiny_ladders, tmp_path):
    """quant_check.main's float, store and mxu PSNRs equal emx's graphs'
    on the same ladder; ood_check and calib_independence write emx's
    keys (docs/runs/quant_r3, docs/runs/qat_r3)."""
    bundle, model, variables = tiny_bundle
    out = quant_check.main(bundle, str(tmp_path), throughput=False,
                           device="cpu")
    noisy, clean = port_ladders.val_ladder(CPU)
    nj, cj = jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy())
    from emx.bench.quant_check import _psnr as emx_psnr
    amax = flax_calibrate(model, variables, [nj[:8]])
    assert abs(out["float_psnr"]
               - emx_psnr(model.apply(variables, nj), cj)) <= 0.01
    for mode in ("store", "mxu"):
        ref = emx_psnr(flax_quantized(model, variables, amax, mode)(nj), cj)
        assert abs(out[f"{mode}_psnr"] - ref) <= 0.05, mode
    ood = quant_check.ood_check(bundle, str(tmp_path), "grains",
                                device="cpu")
    assert set(ood) == _emx_keys("docs/runs/quant_r3/ood_check.json")
    assert ood["family"] == "grain_micrographs"
    calib = quant_check.calib_independence(bundle, str(tmp_path),
                                           device="cpu")
    assert set(calib) == _emx_keys("docs/runs/qat_r3/calib_independence.json")


def test_quant_check_records_the_missing_card(tiny_bundle, on_tiny_ladders,
                                              tmp_path):
    """Throughput needs the card: on the CPU each rate is recorded as an
    error, as emx records a failed timing, and nothing is promoted."""
    bundle, _, _ = tiny_bundle
    out = quant_check.main(bundle, str(tmp_path), psnr_gate=0.0,
                           device="cpu")
    assert "mxu_throughput_error" in out and "mxu_img_per_s" not in out
    assert out["promoted_mode"] is None
    assert not (tmp_path / "bundle.npz").exists()


def test_quant_check_promotes_into_out_dir(tiny_bundle, on_tiny_ladders,
                                           tmp_path, monkeypatch):
    """With rates (the card's, stood in for here) the fastest mode that
    clears the gate is promoted into `out_dir`/bundle.npz, never beside
    the source bundle as emx's `artifact_int8.npz`."""
    bundle, _, _ = tiny_bundle
    rates = iter([100.0, 200.0, 300.0])     # float, store, mxu
    monkeypatch.setattr(quant_check.flagship_decision, "throughput",
                        lambda fn, device: next(rates))
    before = sorted(os.listdir(os.path.dirname(bundle)))
    out = quant_check.main(bundle, str(tmp_path / "out"), psnr_gate=0.0,
                           device="cpu")
    assert out["promoted_mode"] == "mxu"
    assert out["promoted_artifact"] == str(tmp_path / "out" / "bundle.npz")
    assert sorted(os.listdir(os.path.dirname(bundle))) == before
    from emx.serve.artifact import load_denoiser_artifact
    _, _, q = load_denoiser_artifact(out["promoted_artifact"],
                                     with_quant=True)
    assert q["mode"] == "mxu" and q["img_per_s_at_check"] == 300.0


@pytest.fixture
def tiny_quality(on_tiny_ladders, monkeypatch):
    monkeypatch.setattr(quality_run, "MODEL", DenoiserConfig.tiny())
    monkeypatch.setattr(quality_run, "SIZE", 64)


def test_quality_run_end_to_end(tiny_quality, tmp_path):
    """Two steps of the flagship recipe at a tiny width, then a resumed
    call: emx's quality.json keys (docs/runs/quality_r5/quality.json),
    state_bn.npz with emx's layout, the folded bundle."""
    run = str(tmp_path / "q")
    kw = dict(s2d=4, batch=2, norm="batch", folded_head=16,
              corpus="mixed3", corpus_size=8, log_every=1, device="cpu")
    first = quality_run.main(run, steps=2, **kw)
    assert set(first) == _emx_keys("docs/runs/quality_r5/quality.json")
    assert first["steps"] == 2 and abs(first["nn_folded_psnr"]
                                       - first["nn_psnr"]) < 0.05
    with np.load(os.path.join(run, "state_bn.npz")) as z:
        meta = json.loads(bytes(z["__meta_json__"]).decode())
        assert any(k.startswith("batch_stats/") for k in z.files)
    assert meta == {"step": 2, "s2d": 4, "norm": "batch", "folded_head": 16}
    second = quality_run.main(run, steps=3, **kw)
    assert second["steps"] == 3
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert [json.loads(ln)["step"] for ln in f] == [1, 2, 3]
    assert os.path.exists(os.path.join(run, "err_hist", "err_hist.npz"))


def test_quality_run_warm_start(tiny_quality, tmp_path):
    """init_from loads a state_bn.npz (emx's keys) and starts at its
    step: at the requested steps no step trains, and the folded bundle
    is the fold of the loaded state."""
    a = str(tmp_path / "a")
    kw = dict(s2d=4, batch=2, norm="batch", folded_head=16,
              corpus="synthetic", corpus_size=4, log_every=1, device="cpu")
    quality_run.main(a, steps=2, **kw)
    b = str(tmp_path / "b")
    out = quality_run.main(b, steps=2, init_from=os.path.join(
        a, "state_bn.npz"), **kw)
    assert out["steps"] == 2 and not os.path.exists(
        os.path.join(b, "metrics.jsonl")) or os.path.getsize(
        os.path.join(b, "metrics.jsonl")) == 0
    with np.load(os.path.join(a, "artifact.npz")) as za, \
            np.load(os.path.join(b, "artifact.npz")) as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.slow
def test_fold_of_the_flagship_state_equals_the_committed_artifact(
        tmp_path):
    """quality_run.main from docs/runs/quality_r5/state_bn.npz (step
    60000) trains no step, folds, and writes an artifact.npz equal to
    the committed docs/runs/quality_r5/artifact.npz on all 264 arrays."""
    out = quality_run.main(str(tmp_path), s2d=4, steps=60000, batch=2,
                           norm="batch", folded_head=128,
                           init_from=str(ROOT / "docs/runs/quality_r5/"
                                         "state_bn.npz"),
                           corpus_size=2, device="cpu")
    assert out["steps"] == 60000
    with np.load(ROOT / "docs/runs/quality_r5/artifact.npz") as ref, \
            np.load(tmp_path / "artifact.npz") as got:
        arrays = [k for k in ref.files if not k.startswith("__")]
        assert len(arrays) == 264 and set(got.files) == set(ref.files)
        for k in arrays:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_fresh_calibration_of_the_flagship_against_emx(capsys):
    """The flagship bundle on the committed val ladder, both packages on
    the CPU. With the same amax the port's int8 graph gives emx's PSNR
    (0.01 dB): the bundle's recorded amax, and emx's fresh calibration
    on noisy[:8]. A fresh calibration by each package gives maxima of
    bf16 activations that differ by up to ~8% per channel between XLA
    and torch, which moves the PTQ PSNR by ~0.07 dB (printed)."""
    from emx.bench.quant_check import _psnr as emx_psnr
    from emx.serve.artifact import load_denoiser_artifact

    bundle = str(ROOT / "docs/runs/flagship/artifact_int8.npz")
    noisy, clean = port_ladders.val_ladder(CPU)
    nj, cj = jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy())
    cfg, variables, quant = load_denoiser_artifact(bundle, with_quant=True)
    model = FlaxDenoiser(dataclasses.replace(cfg, dtype=jnp.bfloat16))
    emx_amax = flax_calibrate(model, variables, [nj[:8]])
    emx_fn = jax.jit(flax_quantized(model, variables, emx_amax, "mxu"))
    emx_fresh = emx_psnr(jnp.concatenate(
        [emx_fn(nj[i:i + 8]) for i in range(0, 32, 8)]), cj)
    _, _, port = quant_check.deployment_model(bundle, CPU)

    def port_psnr(amax):
        fn = quantized_apply(port, amax, "mxu")
        return port_ladders.mean_psnr(torch.cat(
            [fn(noisy[i:i + 8]) for i in range(0, 32, 8)]), clean)

    recorded = port_psnr(quant["amax"])
    same_amax = port_psnr(emx_amax)
    port_fresh = port_psnr(calibrate(port, [noisy[:8]]))
    with capsys.disabled():
        print(f"\nflagship val PTQ: recorded amax {recorded} (bundle "
              f"{quant['psnr']}); fresh calibration emx {emx_fresh}, port "
              f"{port_fresh}; emx's amax in the port's graph {same_amax}")
    assert abs(recorded - quant["psnr"]) <= 0.01
    assert abs(same_amax - emx_fresh) <= 0.01


# ---- the CLI -----------------------------------------------------------

@pytest.mark.parametrize("cls, argv", [
    ("DenoiserCLIConfig", []),
    ("DenoiserCLIConfig", ["--batch_size=16", "--learning_rate=5e-4",
                           "--data_dir=/tmp/x", "--scale=0.5"]),
    ("InfillingCLIConfig", ["--coverage=16", "--steps=10"]),
])
def test_cli_configs_parse_like_emx(cls, argv):
    """emx's flags parse to emx's values; the port adds `device` (cuda),
    to train-denoiser `steps_per_launch` (1), and to train-infilling the
    values emx's command fixes (`log_every` 100, `ckpt_every_steps`
    10000) and `scale` (1.0)."""
    ref = getattr(emx_cli, cls).from_args(argv).to_dict()
    got = getattr(cli, cls).from_args(argv).to_dict()
    assert {k: got[k] for k in ref} == ref
    assert {k: got[k] for k in set(got) - set(ref)} == (
        {"device": "cuda", "steps_per_launch": 1}
        if cls == "DenoiserCLIConfig" else
        {"device": "cuda", "log_every": 100, "ckpt_every_steps": 10_000,
         "scale": 1.0})


def test_cli_serve_flags():
    c = cli.ServeConfig.from_args(["--artifact=a.npz", "--port=0",
                                   "--max_batch=4", "--device=cpu"])
    assert (c.artifact, c.port, c.max_batch, c.tile, c.overlap,
            c.host, c.device) == ("a.npz", 0, 4, 512, 80, "127.0.0.1",
                                  "cpu")


@pytest.mark.parametrize("command, argv", [
    ("quality", ["runs/q", "4", "20", "16"]),
    ("quality", []),
    ("quant-check", ["b.npz", "out"]),
    ("qat-finetune", ["b.npz", "out", "300", "36.0", "--scope=decoder2"]),
    ("qat-finetune", ["b.npz", "out", "30"]),
    ("gan-quality", ["runs/g", "300"]),
    ("gan-quality", []),
    ("gan-demo", ["runs/d", "200"]),
    ("gan-demo", []),
])
def test_cli_commands_pass_emx_arguments(monkeypatch, command, argv):
    """Each implemented command calls its tool with the arguments emx's
    CLI passes, plus the device."""
    import emx.bench.gan_demo as egd
    import emx.bench.gan_quality as egq
    import emx.bench.qat_finetune as eq
    import emx.bench.quality_run as er
    import emx.bench.quant_check as ec
    from emx_torch.bench import gan_demo, gan_quality
    emx_calls, port_calls = [], []
    for mod, names in ((er, ["main"]), (ec, ["main"]),
                       (eq, ["main", "head_distill"]), (egq, ["main"]),
                       (egd, ["main"])):
        for n in names:
            monkeypatch.setattr(mod, n, lambda *a, _n=n, **k:
                                emx_calls.append((_n, a, k)))
    for mod, names in ((quality_run, ["main"]), (quant_check, ["main"]),
                       (qat_finetune, ["main", "head_distill"]),
                       (gan_quality, ["main"]), (gan_demo, ["main"])):
        for n in names:
            monkeypatch.setattr(mod, n, lambda *a, _n=n, **k:
                                port_calls.append((_n, a, k)))
    emx_cli.COMMANDS[command](list(argv))
    cli.main([command, *argv, "--device=cpu"])
    assert len(emx_calls) == len(port_calls) == 1
    (en, ea, ek), (pn, pa, pk) = emx_calls[0], port_calls[0]
    assert (pn, pa) == (en, ea)
    assert pk == {**ek, "device": "cpu"}


@pytest.mark.parametrize("command", sorted(
    set(emx_cli.COMMANDS) - {"serve", "quality", "quant-check",
                             "qat-finetune", "train-denoiser", "harvest",
                             "bench-train", "train-infilling", "ewrec",
                             "gan-demo", "gan-quality"}))
def test_cli_unported_commands_raise(command):
    assert set(cli.COMMANDS) == set(emx_cli.COMMANDS)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        cli.main([command])


def test_cli_usage():
    with pytest.raises(SystemExit):
        cli.main([])
    with pytest.raises(SystemExit):
        cli.main(["bench"])


def test_cli_qat_finetune_end_to_end(tiny_bundle, on_tiny_ladders, tmp_path):
    """`python -m emx_torch.cli qat-finetune <bundle> <out> 2
    --scope=decoder2 --device=cpu`, in process (the tiny ladders stand
    in for the committed ones): emx's defaults (batch 16, synthetic
    corpus of 1024) at the ladder's 64x64."""
    bundle, _, _ = tiny_bundle
    cli.main(["qat-finetune", bundle, str(tmp_path), "2",
              "--scope=decoder2", "--device=cpu"])
    with open(tmp_path / "qat_tail_decoder2.json") as f:
        out = json.load(f)
    assert out["steps"] == 2 and out["batch"] == 16
    assert (tmp_path / "bundle.npz").exists()
