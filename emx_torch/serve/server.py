"""Batched inference HTTP server (port of emx/serve/server.py).

  POST /api/predict   body: raw .npy bytes (2D float image)
                      resp: raw .npy bytes (same shape)
  GET  /healthz       liveness + model metadata
  GET  /metrics       JSON counters (requests, batched launches, latency)

Requests are queued; a dispatcher thread drains up to `max_batch` at a
time and runs them through the apply function as one batch. A 2D image
that is not the native tile goes through `oversize_fn` (overlapped
tiling) instead. An apply function may return (batch, per-image label)
instead of a batch (auto-select serving); the labels are counted under
metrics["chosen"], keyed by `aux_names`.

Two deliberate departures from `emx`: the metrics counters are updated
under a lock (they are written from three threads), and
`serve_artifact` sets its 50 ms batch-fill window only when
`max_batch > 1`, where batching can help.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import numpy as np
import torch

from emx_torch.serve.artifact import load_denoiser_artifact
from emx_torch.serve.export import load_artifact
from emx_torch.serve.fused import build_graph, load_serve_mode
from emx_torch.serve.select import auto_denoise, serving_candidates
from emx_torch.serve.tiling import tiled_apply
from emx_torch.utils.device import resolve_device


def _host(out: Any) -> np.ndarray:
    """A batch result as a float32 numpy array on the host."""
    if isinstance(out, torch.Tensor):
        return out.detach().float().cpu().numpy()
    return np.asarray(out, np.float32)


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of 128 instead of the
    stdlib's 5, so that a burst of clients connecting at once is queued,
    not reset (emx's server keeps the stdlib's 5)."""

    request_queue_size = 128


class _Pending:
    __slots__ = ("img", "event", "result", "error", "cancelled")

    def __init__(self, img):
        self.img = img
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.cancelled = False


class InferenceServer:
    def __init__(
        self,
        apply_fn: Callable[[np.ndarray], Any],
        host: str = "127.0.0.1",
        port: int = 8501,
        max_batch: int = 8,
        input_shape: tuple[int, int] | None = None,
        model_info: dict | None = None,
        request_timeout_s: float = 120.0,
        pad_batches: bool = False,
        oversize_fn: Callable[[np.ndarray], np.ndarray] | None = None,
        tile_size: int = 512,
        batch_window_s: float = 0.0,
        aux_names: list[str] | None = None,
    ):
        self.apply_fn = apply_fn
        self.max_batch = max_batch
        self.input_shape = input_shape  # stored only, as emx's
        # After the first request of a group arrives, wait up to this
        # long for the group to fill toward max_batch.
        self.batch_window_s = batch_window_s
        # A 2D image whose shape is not the native tile goes through
        # `oversize_fn`, one at a time.
        self.oversize_fn = oversize_fn
        self.tile_size = tile_size
        self._oversize_lock = threading.Lock()
        # Pad ragged groups to the next power of two (copies of row 0,
        # sliced off after), so the batch sizes seen stay few.
        self.pad_batches = pad_batches
        self.request_timeout_s = request_timeout_s
        self.model_info = model_info or {}
        self.metrics = {"requests": 0, "launches": 0, "errors": 0,
                        "batched_images": 0, "total_latency_s": 0.0}
        self.aux_names = aux_names
        if aux_names:
            self.metrics["chosen"] = {name: 0 for name in aux_names}
        self._metrics_lock = threading.Lock()
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch, daemon=True)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    body = json.dumps({"status": "ok", **server.model_info})
                elif self.path == "/metrics":
                    with server._metrics_lock:
                        body = json.dumps(server.metrics)
                else:
                    self._reply(404, b"")
                    return
                self._reply(200, body.encode(), "application/json")

            def do_POST(self):
                if self.path != "/api/predict":
                    self._reply(404, b"")
                    return
                t0 = time.perf_counter()
                # Count every received request up front so errors can
                # never exceed requests.
                server._add(requests=1)
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                try:
                    img = np.load(io.BytesIO(raw), allow_pickle=False)
                except Exception as e:
                    server._add(errors=1)
                    self._reply(400, str(e).encode())
                    return
                if (server.oversize_fn is not None and img.ndim == 2
                        and img.shape != (server.tile_size,
                                          server.tile_size)):
                    try:
                        with server._oversize_lock:
                            out = _host(server.oversize_fn(
                                np.asarray(img, np.float32)))
                    except Exception as e:
                        server._add(errors=1)
                        self._reply(500, str(e).encode())
                        return
                    server._add(launches=1,
                                total_latency_s=time.perf_counter() - t0)
                    buf = io.BytesIO()
                    np.save(buf, out)
                    self._reply(200, buf.getvalue())
                    return
                pending = _Pending(np.asarray(img, np.float32))
                server._q.put(pending)
                if not pending.event.wait(timeout=server.request_timeout_s):
                    # Mark cancelled so a late dispatch drops it.
                    pending.cancelled = True
                    server._add(errors=1)
                    self._reply(504, b"inference timed out")
                    return
                server._add(total_latency_s=time.perf_counter() - t0)
                if pending.error is not None:
                    server._add(errors=1)
                    self._reply(500, str(pending.error).encode())
                    return
                buf = io.BytesIO()
                np.save(buf, pending.result)
                self._reply(200, buf.getvalue())

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def _add(self, **deltas) -> None:
        with self._metrics_lock:
            for k, v in deltas.items():
                self.metrics[k] += v

    def _dispatch(self) -> None:
        # This thread forms groups and launches them; the readback
        # thread copies results to the host and completes the requests,
        # so the next group forms while one result is in flight.
        rq: queue.Queue = queue.Queue(maxsize=2)

        def readback():
            while True:
                item = rq.get()
                if item is None:
                    return
                group, out_dev, n = item
                try:
                    aux = None
                    if isinstance(out_dev, tuple):
                        out_dev, aux = out_dev
                    out = _host(out_dev)[:n]
                    if aux is not None and self.aux_names:
                        chosen = np.asarray(_host(aux), np.int64)[:n]
                        with self._metrics_lock:
                            for c in chosen:
                                self.metrics["chosen"][
                                    self.aux_names[int(c)]] += 1
                    for p, o in zip(group, out):
                        p.result = o
                except Exception as e:  # execution errors surface here
                    for p in group:
                        p.error = e
                finally:
                    for p in group:
                        p.event.set()

        rb = threading.Thread(target=readback, daemon=True)
        rb.start()
        try:
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch = [first]
                if self.batch_window_s:
                    deadline = time.perf_counter() + self.batch_window_s
                    while len(batch) < self.max_batch:
                        rem = deadline - time.perf_counter()
                        if rem <= 0:
                            break
                        try:
                            batch.append(self._q.get(timeout=rem))
                        except queue.Empty:
                            break
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._q.get_nowait())
                    except queue.Empty:
                        break
                by_shape: dict[tuple, list[_Pending]] = {}
                for p in batch:
                    if p.cancelled:  # requester already gave up (504)
                        continue
                    by_shape.setdefault(p.img.shape, []).append(p)
                for group in by_shape.values():
                    # A request may have timed out while queued here.
                    group = [p for p in group if not p.cancelled]
                    if not group:
                        continue
                    try:
                        stacked = np.stack([p.img for p in group])
                        n = stacked.shape[0]
                        if self.pad_batches:
                            m = 1
                            while m < n:
                                m *= 2
                            if m > n:
                                stacked = np.concatenate(
                                    [stacked,
                                     np.repeat(stacked[:1], m - n, axis=0)])
                        out_dev = self.apply_fn(stacked)
                        self._add(launches=1, batched_images=n)
                    except Exception as e:
                        for p in group:
                            p.error = e
                            p.event.set()
                        continue
                    rq.put((group, out_dev, n))
        finally:
            rq.put(None)

    def start(self) -> None:
        self._dispatcher.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._dispatcher.join(timeout=5.0)


AUTO_SEED = 0  # auto-select's fixed mask seed: deterministic serving


def serve_artifact(artifact_path: str, tile: int = 512, overlap: int = 80,
                   device: str | torch.device = "cuda",
                   **kw) -> InferenceServer:
    """Serve a one-file .npz denoiser bundle or a directory artifact
    (emx_torch.serve.export) on `device`.

    Bundles serve 2D images of any size: native-tile requests go through
    the micro-batcher, any other through overlapped tiling. An
    int8-promoted bundle serves its quantized graph: `dense` ("int8" or
    "bf16") folds qualifying SepConvBlocks into dense convs, `fused_rows`
    routes them through the fused kernel (either may come from the
    bundle's serve_mode.json). `auto=True` denoises each request with
    its J-invariant winner among the NN and classical filters
    (emx_torch.serve.select), scored on `auto_n_masks` masks."""
    device = resolve_device(device)
    if not (artifact_path.endswith(".npz") or os.path.isfile(artifact_path)):
        art = load_artifact(artifact_path)
        model_fn = art.apply_fn(device)
        if art.model_name == "denoiser":
            # emx's directory branch runs every request natively, so a
            # side that is no multiple of the net's stride fails there
            # (ROADMAP.md Queue 3); the port tiles such a request.
            grid = 16 * int(art.config.get("space_to_depth", 1))

            def any_size(img: np.ndarray) -> torch.Tensor:
                x = torch.from_numpy(img).to(device)
                if img.shape[0] % grid == 0 and img.shape[1] % grid == 0:
                    return model_fn(x[None])[0]
                return tiled_apply(model_fn, x, tile=tile, overlap=overlap,
                                   batch=8)

            kw.setdefault("oversize_fn", any_size)
            kw.setdefault("tile_size", tile)
        srv = InferenceServer(
            lambda batch: model_fn(torch.from_numpy(batch)),
            model_info={"model": art.model_name, "device": str(device)},
            **kw)
        srv.start()
        return srv
    cfg, model, quant = load_denoiser_artifact(artifact_path, with_quant=True,
                                               device=device)
    fused_rows, dense = 0, ""
    if quant is not None:
        smode = load_serve_mode(artifact_path) or {}
        fused_rows = int(kw.pop("fused_rows", smode.get("fused_rows", 0)))
        dense = str(kw.pop("dense", smode.get("dense", "")))
        graph = build_graph(model, quant, fused_rows=fused_rows, dense=dense)
    else:
        def graph(x):
            with torch.inference_mode():
                return model(x)

    auto = bool(kw.pop("auto", False))
    n_masks = int(kw.pop("auto_n_masks", 2))
    names = None
    if auto:
        names, cands = serving_candidates(graph)
        kw.setdefault("aux_names", names)

        def serve_fn(x):
            return auto_denoise(x, cands, AUTO_SEED, n_masks=n_masks)

        def tile_fn(x):  # the tiled path keeps the output, drops labels
            return serve_fn(x)[0]
    else:
        serve_fn = tile_fn = graph

    def apply_fn(batch: np.ndarray):
        return serve_fn(torch.from_numpy(batch).to(device))

    def oversize_fn(img: np.ndarray) -> torch.Tensor:
        return tiled_apply(tile_fn, torch.from_numpy(img).to(device),
                           tile=tile, overlap=overlap, batch=8)

    kw.setdefault("pad_batches", True)
    if kw.get("max_batch", 8) > 1:
        kw.setdefault("batch_window_s", 0.05)
    kw.setdefault("oversize_fn", oversize_fn)
    kw.setdefault("tile_size", tile)
    info = {"model": "denoiser", "s2d": cfg.space_to_depth,
            "folded_head": cfg.folded_head,
            "quant": None if quant is None else quant["mode"],
            "fused_rows": fused_rows, "dense": dense, "auto": names or False,
            "tile": tile, "overlap": overlap, "device": str(device)}
    srv = InferenceServer(apply_fn, model_info=info, **kw)
    srv.start()
    return srv
