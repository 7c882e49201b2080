"""Write the style artifact's inputs for the PyTorch port:
docs/runs/port_style/inputs.npz.

emx's style artifact (emx/bench/style_artifact.py) draws the feature
pyramid's parameters (emx.nn.style.make_feature_fn) and the canvas noise
(emx.nn.style.transfer_style) from jax.random.key(seed), which the port
cannot reproduce. This script draws both with emx and stores them:

  params/<flax path>   ConvPyramidFeatures' parameters for `size` and
                       `seed` (conv1..conv5 kernels HWIO and biases)
  noise                (size, size) float32 jax.random.normal(key(seed))
  meta_json            size, seed, the sha256 of the arrays
                       (emx_torch.bench.style_artifact.inputs_digest),
                       and emx's own result on this CPU at the record's
                       budget (800 steps, style weight 2000)

The port's style_artifact checks the sha256 on load.

Usage (CPU, about a minute):
    JAX_PLATFORMS=cpu python scripts/make_port_style_inputs.py [out.npz]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from emx.bench.style_artifact import _style_gram_distance  # noqa: E402
from emx.data.pipeline import synthetic_micrographs  # noqa: E402
from emx.nn.style import (ConvPyramidFeatures, StyleTransferConfig,  # noqa: E402
                          transfer_style)
from emx_torch.bench.style_artifact import inputs_digest, style_image  # noqa: E402

OUT = "docs/runs/port_style/inputs.npz"
SIZE, SEED = 128, 0
STEPS, STYLE_WEIGHT = 800, 2000.0   # docs/runs/style_r3/quality.json


def main(out: str = OUT) -> dict:
    model = ConvPyramidFeatures()
    variables = model.init(jax.random.key(SEED), jnp.zeros((1, SIZE, SIZE)))
    params = {k: np.asarray(v, np.float32) for k, v in
              flatten_dict(variables["params"], sep="/").items()}
    content = jnp.asarray(synthetic_micrographs(1, SIZE, seed=42)[0])
    # transfer_style's canvas: content + input_noise * this draw.
    noise = np.asarray(jax.random.normal(jax.random.key(SEED),
                                         content.shape), np.float32)

    # emx's own result on this CPU, as the record's run made it.
    def feature_fn(img):
        return model.apply(variables, img)

    style = jnp.asarray(style_image(SIZE))
    cfg = StyleTransferConfig(steps=STEPS, seed=SEED,
                              style_weight=STYLE_WEIGHT)
    res = transfer_style(content, style, cfg, feature_fn=feature_fn)
    d_content = _style_gram_distance(content, style, feature_fn)
    d_out = _style_gram_distance(res, style, feature_fn)
    corr = float(np.corrcoef(np.asarray(res).ravel(),
                             np.asarray(content).ravel())[0, 1])
    meta = {"size": SIZE, "seed": SEED,
            "sha256": inputs_digest(params, noise),
            "emx_cpu": {"steps": STEPS, "style_weight": STYLE_WEIGHT,
                        "gram_gap_closed": 1.0 - d_out / max(d_content,
                                                             1e-12),
                        "content_correlation": corr,
                        "jax": jax.__version__}}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, noise=noise, meta_json=np.frombuffer(
        json.dumps(meta).encode(), np.uint8),
        **{f"params/{k}": v for k, v in params.items()})
    print(json.dumps(meta), flush=True)
    return meta


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else OUT)
