"""Deployment bundles (port of emx/serve/artifact.py).

A bundle is one .npz: flat flax parameter paths -> float32 arrays, the
DenoiserConfig as JSON bytes under `__config_json__`, and optionally
the int8 serving recipe under `__quant_json__`. Plain numpy reads and
writes it, in emx's format: a bundle the port saves loads in emx's
`load_denoiser_artifact` and the reverse. `save_pytree_npz` and
`load_pytree_like` keep warm-start states (params, batch stats) in the
same one-file form; `save_gan_state` / `load_gan_state` move an
infilling GAN's state (emx's gan_state.npz: gen_params, gen_stats,
disc_params, disc_stats, pred_avg, pred_avg_real) between such a file
and the port's nets, in emx's keys, so either package reads the other's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from emx_torch.nn.denoiser import Denoiser, DenoiserConfig
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.utils.device import resolve_device

_CFG_KEY = "__config_json__"
_QUANT_KEY = "__quant_json__"
_META_KEY = "__meta_json__"
_SEP = "/"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _json_bytes(obj, **kw) -> np.ndarray:
    return np.frombuffer(json.dumps(obj, **kw).encode(), dtype=np.uint8)


def save_denoiser_artifact(path: str, config: DenoiserConfig,
                           variables: dict, quant: dict | None = None
                           ) -> None:
    """Save a Denoiser deployment bundle. `variables` holds inference
    parameters as flat flax dicts, {"params": ...}: fold BatchNorm first
    (emx_torch.serve.optimize.fold_denoiser); a model with batch
    statistics or BatchNorm parameters is refused.

    `quant` optionally promotes an int8 serving mode into the bundle:
    {"mode": "store"|"mxu"|"mxu2", "amax": {conv_path: float or array},
    ...evidence}."""
    params = variables["params"]
    if any(np.size(v) for v in variables.get("batch_stats", {}).values()) \
            or any("/BatchNorm_" in k for k in params):
        raise ValueError("artifact must be a folded (norm-free) model; "
                         "run emx_torch.serve.optimize.fold_denoiser first")
    cfg_json = {f.name: getattr(config, f.name)
                for f in dataclasses.fields(config)}
    cfg_json["dtype"] = _DTYPE_NAMES[config.dtype]
    extra = {_CFG_KEY: _json_bytes(cfg_json, default=list)}
    if quant is not None:
        if quant.get("mode") not in ("store", "mxu", "mxu2") \
                or "amax" not in quant:
            raise ValueError("quant needs a mode store|mxu|mxu2 and amax")
        # amax values may be per-input-channel arrays; JSON them as lists.
        extra[_QUANT_KEY] = _json_bytes(
            quant, default=lambda a: np.asarray(a).tolist())
    flat = {k: np.asarray(v) for k, v in params.items()}
    np.savez(path, **flat, **extra)


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> {"a/b/0": leaf}, emx's key paths."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def save_pytree_npz(path: str, tree, meta: dict | None = None) -> None:
    """Persist nested dicts/lists of tensors or arrays (params, batch
    stats, ...) as one .npz keyed by tree paths, as emx's does; bfloat16
    leaves are widened to float32. `meta` (JSON-serializable) rides
    along under a reserved key."""
    flat = {}
    for key, leaf in _flatten(tree).items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            leaf = leaf.numpy()
        flat[key] = np.asarray(leaf)
    np.savez(path, **flat, **{_META_KEY: _json_bytes(meta or {})})


def load_pytree_like(path: str, ref_tree):
    """Load a save_pytree_npz bundle into the structure of `ref_tree`:
    containers and leaf dtypes (and devices) follow the reference, values
    come from the file. Returns (tree, meta). Raises KeyError if the
    reference has a path the file lacks."""
    with np.load(path) as z:
        meta = (json.loads(bytes(z[_META_KEY]).decode())
                if _META_KEY in z.files else {})
        flat = {k: z[k] for k in z.files if k != _META_KEY}

    def pick(ref, prefix):
        if isinstance(ref, dict):
            return {k: pick(v, f"{prefix}{_SEP}{k}" if prefix else str(k))
                    for k, v in ref.items()}
        if isinstance(ref, (list, tuple)):
            return type(ref)(pick(v, f"{prefix}{_SEP}{i}" if prefix
                                  else str(i)) for i, v in enumerate(ref))
        v = flat[prefix]
        if isinstance(ref, torch.Tensor):
            return torch.from_numpy(np.array(v)).to(ref.device, ref.dtype)
        if isinstance(ref, np.ndarray):
            return v.astype(ref.dtype)
        return type(ref)(v)

    return pick(ref_tree, ""), meta


def save_gan_state(path: str, state, meta: dict | None = None) -> None:
    """Write a GANState's nets and EMAs as emx's gan_state.npz (what
    emx.bench.gan_quality's save_resume writes and init_from reads)."""
    gp, gs = to_flax_params(state.gen)
    dp, ds = to_flax_params(state.disc)
    save_pytree_npz(path, {
        "gen_params": gp, "gen_stats": gs, "disc_params": dp,
        "disc_stats": ds,
        "pred_avg": np.float32(float(state.pred_avg)),
        "pred_avg_real": np.float32(float(state.pred_avg_real))}, meta)


def load_gan_state(path: str, state) -> dict:
    """Fill a GANState's nets and EMAs in place from a gan_state.npz
    (emx's or the port's); returns the file's meta. Optimizer moments are
    untouched (emx's init_from restarts them too). Raises as
    load_flax_params does for a key that fits no port tensor."""
    with np.load(path) as z:
        meta = (json.loads(bytes(z[_META_KEY]).decode())
                if _META_KEY in z.files else {})
        flat = {k: z[k] for k in z.files if k != _META_KEY}

    def part(prefix):
        return {k[len(prefix) + 1:]: v for k, v in flat.items()
                if k.startswith(prefix + _SEP)}

    load_flax_params(state.gen, part("gen_params"), part("gen_stats"))
    load_flax_params(state.disc, part("disc_params"), part("disc_stats"))
    with torch.no_grad():
        state.pred_avg.fill_(float(flat["pred_avg"]))
        state.pred_avg_real.fill_(float(flat["pred_avg_real"]))
    return meta


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
