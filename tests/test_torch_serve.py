"""The slice as a whole on the CPU: the port's serve_artifact answering
HTTP requests against emx's graph on the same int8 bundle."""

import dataclasses
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.serve.artifact import save_denoiser_artifact
from emx.serve.export import save_artifact as flax_save_artifact
from emx.serve.fused import dense_quantized_apply as flax_dense
from emx.serve.fused import fused_quantized_apply as flax_fused
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.tiling import TiledApplier as FlaxTiledApplier
from emx.serve.tiling import tiled_apply as flax_tiled_apply
from emx_torch.ops.sepconv_kernel import fused_sepconv
from emx_torch.serve.artifact import load_denoiser_artifact
from emx_torch.serve.server import InferenceServer, serve_artifact
from emx_torch.serve.tiling import TiledApplier, _origins, tiled_apply

TILE, OVERLAP, ROWS = 128, 32, 16


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny int8 bundle whose body runs at 128x128 on a 128 tile
    (space_to_depth 1), so its stride-1 SepConvBlocks take the fused
    path at the default min_pixels=16384."""
    cfg = dataclasses.replace(FlaxConfig.tiny(), norm="none",
                              space_to_depth=1)
    model = FlaxDenoiser(cfg)
    x = jnp.asarray(np.random.default_rng(5).random((2, TILE, TILE)),
                    jnp.float32)
    variables = model.init(jax.random.key(0), x, train=False)
    amax = flax_calibrate(model, variables, [x])
    path = str(tmp_path_factory.mktemp("bundle") / "artifact_int8.npz")
    save_denoiser_artifact(path, cfg, variables,
                           quant={"mode": "mxu", "amax": amax})
    ref_fn = jax.jit(flax_fused(model, variables, amax, "mxu", rows=ROWS,
                                interpret=True))
    return path, ref_fn, model, variables, amax


@pytest.fixture(scope="module")
def server(bundle):
    srv = serve_artifact(bundle[0], tile=TILE, overlap=OVERLAP,
                         fused_rows=ROWS, device="cpu", port=0)
    yield srv
    srv.stop()


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/predict",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def _npy(img) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _close_to_grid(got, ref):
    # Same int8 grid and exact int32 sums; float32 stages agree to
    # rounding, which can move an input across a grid midpoint: rare
    # single-step departures, so a tight mean and a loose max.
    err = np.abs(got - ref)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())


@pytest.mark.parametrize("shape", [(TILE, TILE), (200, 150), (40, 50)],
                         ids=["native", "oversize", "small"])
def test_predict_matches_flax(bundle, server, shape):
    img = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = _post(server.port, _npy(img))
    assert got.shape == shape and got.dtype == np.float32
    ref_fn = bundle[1]
    if shape == (TILE, TILE):
        ref = np.asarray(ref_fn(jnp.asarray(img[None])))[0]
    else:
        ref = np.asarray(flax_tiled_apply(ref_fn, img, tile=TILE,
                                          overlap=OVERLAP, batch=8))
    _close_to_grid(got, ref)


def test_fused_blocks_take_the_kernel_path(bundle, monkeypatch):
    """Four SepConvBlocks run at 128x128 (encoder block 0 and the
    refinement) and are claimed by the fused path."""
    calls = []

    def spy(x, *args, rows):
        calls.append(tuple(x.shape))
        return fused_sepconv(x, *args, rows=rows)

    monkeypatch.setattr("emx_torch.serve.fused.fused_sepconv", spy)
    srv = serve_artifact(bundle[0], tile=TILE, fused_rows=ROWS,
                         device="cpu", port=0)
    try:
        _post(srv.port, _npy(np.zeros((TILE, TILE), np.float32)))
    finally:
        srv.stop()
    assert len(calls) == 4 and all(s[1:3] == (TILE, TILE) for s in calls)


def test_garbage_body_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, b"not an npy file")
    assert e.value.code == 400
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info["quant"] == "mxu" and info["fused_rows"] == ROWS
    assert info["device"] == "cpu"


def test_batch_window_only_when_batching(bundle):
    srv = serve_artifact(bundle[0], tile=TILE, device="cpu", port=0)
    one = serve_artifact(bundle[0], tile=TILE, device="cpu", port=0,
                         max_batch=1)
    try:
        assert srv.batch_window_s == 0.05
        assert one.batch_window_s == 0.0
    finally:
        srv.stop()
        one.stop()


def test_default_device_is_cuda(bundle):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_artifact(bundle[0], tile=TILE, port=0)


def test_unported_modes_raise(bundle, tmp_path):
    """Every serving mode of emx's serve_artifact is ported (dense, auto
    and directory artifacts have tests below); what is no mode raises."""
    with pytest.raises(ValueError, match="dense"):
        serve_artifact(bundle[0], device="cpu", port=0, dense="int4")
    with pytest.raises(FileNotFoundError):
        serve_artifact(str(tmp_path), device="cpu", port=0)


@pytest.mark.parametrize("dense", ["int8", "bf16"])
def test_dense_serving_matches_flax(bundle, dense):
    """Dense-folded serving against emx's dense graph. The "bf16" fold
    runs in float (this config is float32) and its outputs, which agree
    with emx's to ~6e-8, feed int8 convs: float32 sums in another order
    push more inputs across a grid midpoint than in the all-int8 graph,
    so its mean departure is held to 5e-4 instead of 1e-4."""
    path, _, model, variables, amax = bundle
    img = np.random.default_rng(7).random((TILE, TILE)).astype(np.float32)
    srv = serve_artifact(path, tile=TILE, dense=dense, device="cpu", port=0)
    try:
        got = _post(srv.port, _npy(img))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            info = json.loads(r.read())
    finally:
        srv.stop()
    assert info["dense"] == dense and info["auto"] is False
    ref = np.asarray(jax.jit(flax_dense(
        model, variables, amax, "mxu", quantized=dense == "int8"))(
        jnp.asarray(img[None])))[0]
    if dense == "int8":
        _close_to_grid(got, ref)
    else:
        err = np.abs(got - ref)
        assert err.mean() < 5e-4 and err.max() < 1e-2, (err.mean(),
                                                        err.max())


def test_auto_serving_answers_and_counts(bundle):
    """auto=True: native requests are batched through auto_denoise and
    counted under metrics["chosen"]; the tiled path keeps the output."""
    srv = serve_artifact(bundle[0], tile=TILE, overlap=OVERLAP, auto=True,
                         fused_rows=ROWS, device="cpu", port=0)
    rng = np.random.default_rng(8)
    try:
        outs = [_post(srv.port, _npy(rng.random(shape).astype(np.float32)))
                for shape in [(TILE, TILE), (TILE, TILE), (150, 200)]]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        info = srv.model_info
    finally:
        srv.stop()
    assert [o.shape for o in outs] == [(TILE, TILE), (TILE, TILE),
                                       (150, 200)]
    assert all(np.isfinite(o).all() for o in outs)
    assert info["auto"] == ["nn", "gaussian", "median", "wiener", "tv"]
    assert sum(metrics["chosen"].values()) == 2
    assert set(metrics["chosen"]) == set(info["auto"])


def test_directory_artifact_is_served(bundle, tmp_path):
    """A directory artifact written by emx, served by the port: float32
    forward within 1e-5 of emx's."""
    _, _, model, variables, _ = bundle
    flax_save_artifact(str(tmp_path), "denoiser",
                       dataclasses.asdict(model.config), variables)
    img = np.random.default_rng(9).random((TILE, TILE)).astype(np.float32)
    srv = serve_artifact(str(tmp_path), device="cpu", port=0)
    try:
        got = _post(srv.port, _npy(img))
        info = srv.model_info
    finally:
        srv.stop()
    assert info["model"] == "denoiser"
    ref = np.asarray(model.apply(variables, jnp.asarray(img[None]),
                                 train=False))[0]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_tiled_applier_matches_flax(bundle):
    """Whole-image preprocessing (a NaN pixel, an offset range), then
    overlapped tiles; and one crop. float32 within 1e-5."""
    path, _, model, variables, _ = bundle
    _, port = load_denoiser_artifact(path, device="cpu")
    img = 3.0 + np.random.default_rng(10).random((200, 150)).astype(
        np.float32)
    img[5, 7] = np.nan
    ref = FlaxTiledApplier(model, variables, tile=TILE, overlap=OVERLAP,
                           batch=3)
    got = TiledApplier(port, tile=TILE, overlap=OVERLAP, batch=3)
    np.testing.assert_allclose(got(img).numpy(), np.asarray(ref(img)),
                               rtol=0, atol=1e-5)
    crop = img[:TILE, :TILE] if img.shape[1] >= TILE else np.pad(
        img, ((0, 0), (0, TILE - img.shape[1])), mode="reflect")[:TILE]
    np.testing.assert_allclose(got.apply_crop(crop).numpy(),
                               np.asarray(ref.apply_crop(crop)),
                               rtol=0, atol=1e-5)


def _load(clients: int, rounds: int) -> None:
    """`clients` threads each post `rounds` requests, all started
    together; every request is answered, with its own result, and no
    counter update is lost."""
    srv = InferenceServer(lambda x: x * 2.0, port=0, max_batch=4)
    srv.start()
    n = clients * rounds
    outs = [None] * n
    img = np.ones((8, 8), np.float32)
    start = threading.Barrier(clients)

    def client(c):
        start.wait()
        for r in range(rounds):
            i = r * clients + c
            outs[i] = _post(srv.port, _npy(img * i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, img * i * 2.0)
        m = srv.metrics
        assert m["requests"] == n and m["batched_images"] == n
        assert m["errors"] == 0 and 0 < m["launches"] <= n
    finally:
        sys.setswitchinterval(interval)
        srv.stop()


def test_metrics_lose_no_update_under_load():
    """Counters are written from handler, dispatcher and readback
    threads; under many concurrent clients none is lost."""
    _load(clients=12, rounds=4)


def test_burst_of_48_clients_is_answered():
    """48 clients connecting at once: the listen backlog queues them
    (the stdlib's backlog of 5 reset some connections)."""
    _load(clients=48, rounds=1)


def test_origins_and_tiling_average():
    assert list(_origins(1024, 512, 432)) == [0, 432, 512]
    assert list(_origins(768, 512, 432)) == [0, 256]
    assert list(_origins(300, 512, 432)) == [0]
    # An identity model reproduces the image through overlap averaging
    # and through reflect growth of a small image.
    for shape in [(300, 200), (7, 5), (1, 9)]:
        img = torch.from_numpy(
            np.random.default_rng(1).random(shape).astype(np.float32))
        out = tiled_apply(lambda b: b, img, tile=64, overlap=16, batch=3)
        torch.testing.assert_close(out, img)
