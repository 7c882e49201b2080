"""HTTP serving latency and throughput on the card (port of
emx/bench/serve_latency.py).

Serves a bundle with the port's micro-batching server on the card and
drives it over real HTTP (raw .npy bodies) at a constant closed-loop
concurrency; records the latency distribution (p50/p90/p99), aggregate
img/s and images per launch, and the latency of oversize (tiled)
requests. Writes `out_dir`/serve_latency.json (or _c<concurrency>).

Usage: python -m emx_torch.bench.serve_latency OUT_DIR [bundle]
    [concurrency] [requests_per_worker] [size]
"""

from __future__ import annotations

import http.client
import io
import json
import os
import sys
import threading
import time

import numpy as np

from emx_torch.bench.flagship_decision import FLAGSHIP
from emx_torch.serve.server import serve_artifact
from emx_torch.utils.device import card_name_and_power


def post(port: int, arr: np.ndarray, timeout: float = 120.0) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/api/predict", body=buf.getvalue())
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{resp.status}: {body[:200]!r}")
    return np.load(io.BytesIO(body))


def get_json(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _wave(port: int, imgs: np.ndarray) -> None:
    ts = [threading.Thread(target=post, args=(port, im)) for im in imgs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def main(out_dir: str, bundle: str = FLAGSHIP, concurrency: int = 16,
         requests_per_worker: int = 32, size: int = 512,
         oversize=(2048, 4096), device: str = "cuda") -> dict:
    srv = serve_artifact(bundle, port=0, max_batch=concurrency,
                         device=device)
    try:
        rng = np.random.default_rng(0)
        imgs = rng.random((concurrency, size, size), np.float32)
        # Warm-up: every padded batch size once, then two HTTP waves.
        t0 = time.perf_counter()
        m = 1
        while m <= concurrency:
            out = srv.apply_fn(imgs[:m])
            (out[0] if isinstance(out, tuple) else out).cpu()
            m *= 2
        for _ in range(2):
            _wave(srv.port, imgs)
        warmup_s = time.perf_counter() - t0

        lat: list[float] = []
        lock = threading.Lock()
        errors: list[BaseException] = []

        def worker(i: int):
            mine = []
            try:
                for _ in range(requests_per_worker):
                    t = time.perf_counter()
                    out = post(srv.port, imgs[i])
                    mine.append(time.perf_counter() - t)
                    if out.shape != (size, size):
                        raise AssertionError(f"shape {out.shape}")
            except BaseException as e:  # reported after the join
                errors.append(e)
            with lock:
                lat.extend(mine)

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(concurrency)]
        with srv._metrics_lock:
            for k in ("requests", "launches", "errors", "batched_images"):
                srv.metrics[k] = 0
            srv.metrics["total_latency_s"] = 0.0
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        n = len(lat_ms)

        def pct(p):
            return float(lat_ms[min(n - 1, int(p / 100 * n))])

        metrics = get_json(srv.port, "/metrics")
        over = {}
        for s in oversize:
            big = rng.random((s, s), np.float32)
            post(srv.port, big, timeout=600.0)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                if post(srv.port, big, timeout=600.0).shape != (s, s):
                    raise AssertionError("oversize shape")
                times.append(time.perf_counter() - t)
            over[f"{s}x{s}_ms"] = float(np.median(times)) * 1e3
    finally:
        srv.stop()
    out = {"metric": "serve_latency", "bundle": bundle,
           "device": card_name_and_power(), "concurrency": concurrency,
           "requests": n, "size": size, "p50_ms": pct(50),
           "p90_ms": pct(90), "p99_ms": pct(99),
           "mean_ms": float(np.mean(lat_ms)),
           "throughput_img_per_s": n / wall,
           "img_per_launch": (metrics["batched_images"]
                              / max(metrics["launches"], 1)),
           "batch_window_s": srv.batch_window_s, "warmup_s": warmup_s,
           "oversize_latency": over, "server_metrics": metrics}
    os.makedirs(out_dir, exist_ok=True)
    name = ("serve_latency.json" if concurrency == 16
            else f"serve_latency_c{concurrency}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1] if len(a) > 1 else FLAGSHIP,
         int(a[2]) if len(a) > 2 else 16, int(a[3]) if len(a) > 3 else 32,
         int(a[4]) if len(a) > 4 else 512)
