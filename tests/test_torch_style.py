"""Style transfer (emx_torch/nn/style.py, emx_torch/bench/
style_artifact.py) against emx's on the CPU, on emx's feature-pyramid
parameters and emx's canvas noise.

Tolerances (float32 on both sides): pyramid features and Gram matrices
rtol 1e-5; the style/content loss rtol 1e-5; transfer_style's canvas
after 5 Adam steps within 1e-5 (Adam's first steps move every pixel by
~lr = 0.05, so a sign error would show as 0.1); RestyleNet's output
within 1e-4 (seen 3e-5: instance norms over 4x4 maps in its middle);
train_fast_restyler's first loss rtol 1e-5 and its second, after one
Adam step, rtol 1e-3 (the loss is ~5e-5, so many gradients sit near
Adam's eps 1e-8, where the step's size follows their last bits; seen
3.1e-4). The committed inputs file holds exactly
emx's draws for size 128 and seed 0, and a file that misses its
recorded sha256 is refused."""

import fnmatch
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.analysis.stats import gram_matrix as emx_gram
from emx.nn import style as es
from emx_torch.analysis.stats import gram_matrix
from emx_torch.bench import style_artifact
from emx_torch.nn import style as ps
from emx_torch.serve.convert import load_flax_params
from torch_zoo_helpers import as_emx, emx_variables, ref_jit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def small():
    """emx's pyramid for 32x32 (its tree at random values), a content, a
    style, emx's noise."""
    size = 32
    model = es.ConvPyramidFeatures()
    variables = as_emx(emx_variables(model, jnp.zeros((1, size, size))))
    content = np.random.default_rng(0).random((size, size)).astype(
        np.float32)
    style = style_artifact.style_image(size)
    noise = np.array(jax.random.normal(jax.random.key(0), (size, size)))
    return {"size": size, "model": model, "variables": variables,
            "params": _flat(variables["params"]), "content": content,
            "style": style, "noise": noise}


def test_features_and_loss_match_emx(small):
    fn = ps.make_feature_fn(small["size"], params=small["params"],
                            device=CPU)
    x = small["content"]
    feats = ref_jit(small["model"].apply)
    ref = feats(small["variables"], jnp.asarray(x))
    with torch.no_grad():
        got = fn(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(gram_matrix(got[k][0]).numpy(),
                                   np.asarray(emx_gram(ref[k][0])),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    sref = feats(small["variables"], jnp.asarray(small["style"]))
    grams = [{k: emx_gram(sref[k][0]) for k in es.STYLE_LAYERS}]
    with torch.no_grad():
        sgot = fn(torch.from_numpy(small["style"]))
        cgot = fn(torch.from_numpy(small["content"] * 0.5))
    pgrams = [{k: gram_matrix(sgot[k][0]) for k in ps.STYLE_LAYERS}]
    cref = feats(small["variables"], jnp.asarray(small["content"] * 0.5))
    args = ((0.2,) * 5, [1.0], 1.0, 200.0)
    lref = es.style_content_loss(ref, cref, grams, *args)
    lgot = ps.style_content_loss(got, cgot, pgrams, *args)
    np.testing.assert_allclose(float(lgot), float(lref), rtol=1e-5)


def test_transfer_style_matches_emx(small):
    cfg_e = es.StyleTransferConfig(steps=5, style_weight=2000.0)
    cfg_p = ps.StyleTransferConfig(steps=5, style_weight=2000.0)
    variables = small["variables"]
    ref = np.asarray(es.transfer_style(
        jnp.asarray(small["content"]), jnp.asarray(small["style"]), cfg_e,
        feature_fn=jax.jit(lambda img: small["model"].apply(variables,
                                                            img))))
    fn = ps.make_feature_fn(small["size"], params=small["params"],
                            device=CPU)
    got = ps.transfer_style(torch.from_numpy(small["content"]),
                            torch.from_numpy(small["style"]), cfg_p,
                            feature_fn=fn,
                            noise=torch.from_numpy(small["noise"])).numpy()
    start = np.clip(small["content"] + 0.1 * small["noise"], 0, 1)
    assert np.abs(ref - start).max() > 0.1          # the steps moved it
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_restyler_matches_emx():
    """RestyleNet's forward, and train_fast_restyler's first two losses
    against emx's loop restated (emx/nn/style.py train_fast_restyler's
    loss_fn and Adam step, which draws its net from key(cfg.seed)) on the
    same initial RestyleNet."""
    size = 16
    rng = np.random.default_rng(1)
    batches = [rng.random((1, size, size)).astype(np.float32)
               for _ in range(2)]
    style = jnp.asarray(style_artifact.style_image(size))
    model = es.ConvPyramidFeatures()
    fflat = emx_variables(model, jnp.zeros((1, size, size)), seed=2)
    fvars = as_emx(fflat)

    feature_fn = jax.jit(lambda img: model.apply(fvars, img))

    net = es.RestyleNet(features=(8, 8, 16), num_blocks=1)
    nflat = emx_variables(net, jnp.asarray(batches[0]), train=False, seed=3)
    params = as_emx(nflat)["params"]
    cfg = es.StyleTransferConfig(learning_rate=1e-3)
    grams = [{k: emx_gram(v[0]) for k, v in feature_fn(style).items()
              if k in es.STYLE_LAYERS}]
    opt = optax.adam(cfg.learning_rate)

    @ref_jit
    def step(p, s, batch):
        def loss_fn(p):
            out = net.apply({"params": p}, batch, train=True)
            loss = 0.0
            for i in range(batch.shape[0]):
                loss = loss + es.style_content_loss(
                    feature_fn(out[i]), feature_fn(batch[i]), grams,
                    cfg.style_layer_weights, [1.0], cfg.content_weight,
                    cfg.style_weight)
            return loss / batch.shape[0]

        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, loss

    ref_out = np.asarray(ref_jit(net.apply)({"params": params},
                                            jnp.asarray(batches[0])))
    ref_losses, s = [], opt.init(params)
    for b in batches:
        params, s, loss = step(params, s, jnp.asarray(b))
        ref_losses.append(float(loss))
    port = load_flax_params(ps.RestyleNet(features=(8, 8, 16), num_blocks=1,
                                          device=CPU), nflat["params"])
    with torch.no_grad():
        out = port(torch.from_numpy(batches[0]))
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-4)
    fn = ps.make_feature_fn(size, params=fflat["params"], device=CPU)
    _, losses = ps.train_fast_restyler(
        batches, torch.from_numpy(np.asarray(style)),
        ps.StyleTransferConfig(learning_rate=1e-3), num_steps=2,
        feature_fn=fn, net=port, device=CPU)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1], ref_losses[1], rtol=1e-3)


def test_committed_inputs_are_emx_draws(tmp_path):
    params, noise = style_artifact.load_style_inputs(128, 0)
    variables = jax.jit(es.ConvPyramidFeatures().init)(
        jax.random.key(0), jnp.zeros((1, 128, 128)))
    ref = _flat(variables["params"])
    assert set(params) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(params[k], ref[k])
    np.testing.assert_array_equal(noise, np.asarray(
        jax.random.normal(jax.random.key(0), (128, 128))))
    with pytest.raises(ValueError, match="size 128"):
        style_artifact.load_style_inputs(64, 0)
    # One changed number and the recorded sha256 no longer holds.
    with np.load(style_artifact.INPUTS) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["noise"] = arrays["noise"].copy()
    arrays["noise"][0, 0] += 1.0
    bad = tmp_path / "inputs.npz"
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="sha256"):
        style_artifact.load_style_inputs(128, 0, str(bad))


def test_inputs_reach_the_chip_copy():
    """No .chiprunignore pattern leaves the inputs out of a chip copy."""
    rel = "docs/runs/port_style/inputs.npz"
    with open(os.path.join(ROOT, ".chiprunignore")) as f:
        pats = [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]
    parts = rel.split("/")
    for p in pats:
        p = p.rstrip("/")
        hit = (fnmatch.fnmatch(rel, p) or any(fnmatch.fnmatch(q, p)
                                              for q in parts))
        assert not hit, f"{p} leaves out {rel}"
    assert os.path.getsize(os.path.join(ROOT, rel)) < 4 << 20


def test_style_artifact_runs_on_the_cpu(tmp_path, monkeypatch):
    """main() at a cut budget: emx's content and style, its TIFFs and
    quality.json with emx's keys; no time recorded from a CPU. The
    optimisation runs under cuDNN's deterministic algorithms, and the
    caller's setting is back after it."""
    import emx_torch.nn.style as ps

    seen, transfer = [], ps.transfer_style

    def recording(*a, **kw):
        seen.append(torch.backends.cudnn.deterministic)
        return transfer(*a, **kw)

    monkeypatch.setattr(ps, "transfer_style", recording)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    out = style_artifact.main(str(tmp_path), 128, 2, 2000.0, device=CPU)
    assert seen == [True] and not torch.backends.cudnn.deterministic
    assert sorted(os.listdir(tmp_path)) == ["content.tif", "output.tif",
                                            "quality.json", "style.tif"]
    with open(os.path.join(ROOT, "docs/runs/style_r3/quality.json")) as f:
        rec = json.load(f)
    assert set(rec) <= set(out)
    assert out["seconds"] is None and out["steps"] == 2
    from emx_torch.io.tiff import read_tiff
    np.testing.assert_array_equal(read_tiff(str(tmp_path / "style.tif")),
                                  style_artifact.style_image(128))
    shutil.rmtree(tmp_path)
