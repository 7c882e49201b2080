"""Deployment bundles (port of the loader in emx/serve/artifact.py).

A bundle is one .npz: flat flax parameter paths -> float32 arrays, the
DenoiserConfig as JSON bytes under `__config_json__`, and optionally
the int8 serving recipe under `__quant_json__`. Plain numpy reads it;
the weights are converted in memory and never written back.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from emx_torch.nn.denoiser import Denoiser, DenoiserConfig
from emx_torch.serve.convert import load_flax_params
from emx_torch.utils.device import resolve_device

_CFG_KEY = "__config_json__"
_QUANT_KEY = "__quant_json__"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def read_artifact(path: str):
    """(DenoiserConfig, flat params, quant dict or None) of a bundle."""
    with np.load(path) as z:
        cfg_d: dict[str, Any] = json.loads(bytes(z[_CFG_KEY]).decode())
        quant = (json.loads(bytes(z[_QUANT_KEY]).decode())
                 if _QUANT_KEY in z.files else None)
        flat = {k: z[k] for k in z.files if k not in (_CFG_KEY, _QUANT_KEY)}
    if quant is not None:
        quant["amax"] = {k: (np.asarray(v, dtype=np.float32)
                             if isinstance(v, list) else v)
                         for k, v in quant["amax"].items()}
    # JSON round-trips tuples as lists; restore every tuple-typed field.
    for f in dataclasses.fields(DenoiserConfig):
        if (f.name in cfg_d and isinstance(cfg_d[f.name], list)
                and isinstance(getattr(DenoiserConfig(), f.name), tuple)):
            cfg_d[f.name] = tuple(cfg_d[f.name])
    cfg_d["dtype"] = _DTYPES[cfg_d["dtype"]]
    # A training-memory knob; a serving graph does not carry it.
    cfg_d["remat_middle"] = False
    return DenoiserConfig(**cfg_d), flat, quant


def load_denoiser_artifact(path: str, with_quant: bool = False,
                           device: str | torch.device = "cuda"):
    """Load a bundle; returns (DenoiserConfig, Denoiser on `device` in
    eval mode), plus the quant dict (or None) when `with_quant`."""
    device = resolve_device(device)
    config, flat, quant = read_artifact(path)
    model = load_flax_params(Denoiser(config, device="cpu"), flat)
    model = model.to(device).eval().requires_grad_(False)
    if with_quant:
        return config, model, quant
    return config, model
