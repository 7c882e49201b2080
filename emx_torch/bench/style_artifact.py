"""Style-transfer visual regression artifact (port of
emx/bench/style_artifact.py).

Runs the Gatys-style optimisation on a fixed (seed, content, style) pair
and writes the content, style and output images and the Gram distances:
the output's style-Gram distance must close most of the gap from the
content to the style while keeping the content's structure (its
correlation with the content image). Reference:
machine_learning/style_transfer.py:125-204.

emx draws the feature pyramid's parameters and the canvas noise from
jax.random.key(seed); the port reads both from
docs/runs/port_style/inputs.npz (written by
scripts/make_port_style_inputs.py with emx), whose recorded sha256 of
those arrays is checked on load. The content is synthetic_micrographs(
1, size, seed=42) (numpy, emx's), the style a lattice of two sine
fringes. The optimisation runs cuDNN's deterministic algorithms, so
that it repeats on one card.

Usage: python -m emx_torch.bench.style_artifact [out_dir] [size] [steps]
[style_weight] [--device=cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from emx_torch.utils.device import cudnn_deterministic, resolve_device

INPUTS = "docs/runs/port_style/inputs.npz"


def inputs_digest(params: dict[str, np.ndarray], noise: np.ndarray) -> str:
    """sha256 over the parameters (sorted by name) and the noise, float32."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(params[k], np.float32).tobytes())
    h.update(np.ascontiguousarray(noise, np.float32).tobytes())
    return h.hexdigest()


def load_style_inputs(size: int, seed: int = 0, path: str = INPUTS):
    """(feature parameters as a flat flax dict, canvas noise (size, size))
    from the inputs file. Raises ValueError when the file was made for
    another size or seed, or its arrays miss the recorded sha256."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
        noise = z["noise"]
    if (meta["size"], meta["seed"]) != (size, seed):
        raise ValueError(f"{path} holds size {meta['size']} seed "
                         f"{meta['seed']}, asked for {size} and {seed}")
    digest = inputs_digest(params, noise)
    if digest != meta["sha256"]:
        raise ValueError(f"{path}: arrays' sha256 {digest} is not the "
                         f"recorded {meta['sha256']}")
    return params, noise


def style_image(size: int) -> np.ndarray:
    """Strong directional lattice fringes (a STEM texture) in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    style = 0.5 + 0.25 * np.sin(2 * np.pi * 24 * (0.8 * xx + 0.6 * yy)) \
        + 0.25 * np.sin(2 * np.pi * 31 * (0.6 * xx - 0.8 * yy))
    return ((style - style.min()) / (style.max() - style.min())).astype(
        np.float32)


def style_gram_distance(img: torch.Tensor, style: torch.Tensor,
                        feature_fn) -> float:
    from emx_torch.analysis.stats import gram_matrix
    from emx_torch.nn.style import STYLE_LAYERS

    with torch.no_grad():
        fi, fs = feature_fn(img), feature_fn(style)
        return sum(float(torch.mean((gram_matrix(fi[layer][0])
                                     - gram_matrix(fs[layer][0])) ** 2))
                   for layer in STYLE_LAYERS)


def main(out_dir: str = "docs/runs/port_style", size: int = 128,
         steps: int = 300, style_weight: float = 200.0,
         inputs: str = INPUTS, device: str | torch.device = "cuda") -> dict:
    from emx_torch.data.pipeline import synthetic_micrographs
    from emx_torch.io.tiff import write_tiff
    from emx_torch.nn.style import (StyleTransferConfig, make_feature_fn,
                                    transfer_style)

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = StyleTransferConfig(steps=steps, seed=0, style_weight=style_weight)
    params, noise = load_style_inputs(size, cfg.seed, inputs)
    content = torch.from_numpy(synthetic_micrographs(1, size, seed=42)[0]
                               ).to(dev)
    style = torch.from_numpy(style_image(size)).to(dev)
    feature_fn = make_feature_fn(size, cfg.seed, params=params, device=dev)
    t0 = time.perf_counter()
    # cuDNN's default algorithms do not repeat on the card: over five
    # H100 runs gram_gap_closed spread over 0.0038, close to its whole
    # margin under the record's. The artifact runs the deterministic ones.
    with cudnn_deterministic():
        out = transfer_style(content, style, cfg, feature_fn=feature_fn,
                             noise=torch.from_numpy(noise).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    d_content = style_gram_distance(content, style, feature_fn)
    d_out = style_gram_distance(out, style, feature_fn)
    out_np, content_np = out.cpu().numpy(), content.cpu().numpy()
    corr = float(np.corrcoef(out_np.ravel(), content_np.ravel())[0, 1])
    write_tiff(os.path.join(out_dir, "content.tif"), content_np)
    write_tiff(os.path.join(out_dir, "style.tif"), style.cpu().numpy())
    write_tiff(os.path.join(out_dir, "output.tif"), out_np)
    summary = {
        "metric": "style_transfer_artifact", "size": size, "steps": steps,
        "style_weight": style_weight,
        "style_gram_dist_content": round(d_content, 6),
        "style_gram_dist_output": round(d_out, 6),
        "gram_gap_closed": round(1.0 - d_out / max(d_content, 1e-12), 4),
        "content_correlation": round(corr, 4),
        "ok": bool(d_out < 0.5 * d_content and corr > 0.3),
        "gram_gap_closed_exact": 1.0 - d_out / max(d_content, 1e-12),
        "content_correlation_exact": corr,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        # Optimisation seconds, on the card only (no time from a CPU).
        "seconds": round(seconds, 3) if dev.type == "cuda" else None,
    }
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    flags = {a.split("=", 1)[0]: a.split("=", 1)[1]
             for a in sys.argv[1:] if a.startswith("--") and "=" in a}
    a = [x for x in sys.argv[1:] if not x.startswith("-")]
    main(a[0] if a else "docs/runs/port_style",
         int(a[1]) if len(a) > 1 else 128,
         int(a[2]) if len(a) > 2 else 300,
         float(a[3]) if len(a) > 3 else 200.0,
         device=flags.get("--device", "cuda"))
