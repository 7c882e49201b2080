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
from emx.serve.fused import fused_quantized_apply as flax_fused
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.tiling import tiled_apply as flax_tiled_apply
from emx_torch.ops.sepconv_kernel import fused_sepconv
from emx_torch.serve.server import InferenceServer, serve_artifact
from emx_torch.serve.tiling import _origins, tiled_apply

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
    return path, ref_fn


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
    _, ref_fn = bundle
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


def test_unported_modes_raise(bundle):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_artifact(bundle[0], device="cpu", port=0, auto=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_artifact(bundle[0], device="cpu", port=0, dense="int8")


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
