"""Carry flax parameters into the port's modules, and back out.

The input is the flat `{"A/B/Conv_0/kernel": array}` dict of a bundle
(or of `flax.traverse_util.flatten_dict(params, sep="/")`). Each port
module's dotted name is its flax path, so every parameter has exactly
one key. Layouts change on the way in:

  * conv kernels go from HWIO to OIHW (a depthwise (3, 3, 1, C) kernel
    becomes (C, 1, 3, 3));
  * transposed-conv kernels are also flipped in space, to (I, O, 3, 3);
  * norm `scale` becomes `weight`; BatchNorm `mean`/`var` come from
    the `batch_stats` collection.

Anything left over on either side raises. `to_flax_params` is the
inverse: it gives back the flat flax dicts of a port model, kernels in
HWIO and transposed-conv kernels flipped back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from emx_torch.nn.blocks import BatchNorm, Conv, ConvTranspose, GroupNorm


def _source(mod: nn.Module, name: str):
    """(collection, flax leaf name, layout change in, layout change out)
    of a port tensor."""
    coll = getattr(mod, "FLAX_COLLECTIONS", {}).get(name)
    if coll is not None:
        return coll, name, None, None
    if name == "weight" and isinstance(mod, ConvTranspose):
        return ("params", "kernel",
                lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1),
                lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1])
    if name == "weight" and isinstance(mod, Conv):
        return ("params", "kernel", lambda k: k.transpose(3, 2, 0, 1),
                lambda w: w.transpose(2, 3, 1, 0))
    if name == "weight" and isinstance(mod, (GroupNorm, BatchNorm)):
        return "params", "scale", None, None
    if name in ("mean", "var") and isinstance(mod, BatchNorm):
        return "batch_stats", name, None, None
    return "params", name, None, None


def _tensors(model: nn.Module):
    """(flax collection, flat key, port tensor, change in, change out) of
    every parameter and buffer of `model`."""
    for mname, mod in model.named_modules():
        prefix = mname.replace(".", "/")
        buffers = [(n, t) for n, t in mod.named_buffers(recurse=False)
                   if n not in mod._non_persistent_buffers_set]
        for name, t in list(mod.named_parameters(recurse=False)) + buffers:
            coll, leaf, change_in, change_out = _source(mod, name)
            key = f"{prefix}/{leaf}" if prefix else leaf
            yield coll, key, t, change_in, change_out


def load_flax_params(model: nn.Module, params: dict[str, np.ndarray],
                     batch_stats: dict[str, np.ndarray] | None = None,
                     spectral: dict[str, np.ndarray] | None = None
                     ) -> nn.Module:
    """Fill `model` in place from flat flax dicts; returns `model`.
    `spectral` is the VAE-GAN's power-iteration collection (the `u` of
    emx_torch.nn.vaegan's SNConv and SNDense).

    Raises KeyError for a port tensor with no key, ValueError for a
    shape mismatch or for keys that no port tensor used."""
    flat = {"params": dict(params), "batch_stats": dict(batch_stats or {}),
            "spectral": dict(spectral or {})}
    used: dict[str, set] = {k: set() for k in flat}
    with torch.no_grad():
        for coll, key, t, change, _ in _tensors(model):
            if key not in flat[coll]:
                raise KeyError(f"no {coll} entry {key!r} for a port tensor")
            a = np.array(flat[coll][key], dtype=np.float32)
            if change is not None:
                a = change(a)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{coll} {key!r}: shape {a.shape} "
                                 f"does not fit {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            used[coll].add(key)
    for coll, entries in flat.items():
        unused = sorted(set(entries) - used[coll])
        if unused:
            raise ValueError(f"{len(unused)} {coll} entries unused by the "
                             f"port: {unused[:5]}")
    return model


def to_flax_variables(model: nn.Module) -> dict[str, dict[str, np.ndarray]]:
    """Every flax collection of `model` as flat dicts of float32 numpy in
    flax's layouts: {"params": ..., "batch_stats": ..., ...}."""
    flat: dict[str, dict[str, np.ndarray]] = {"params": {},
                                              "batch_stats": {}}
    for coll, key, t, _, change in _tensors(model):
        a = t.detach().float().cpu().numpy()
        if change is not None:
            a = change(a)
        flat.setdefault(coll, {})[key] = np.ascontiguousarray(a)
    return flat


def to_flax_params(model: nn.Module
                   ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The flat flax dicts (params, batch_stats) of `model`, float32
    numpy in flax's layouts; `load_flax_params` of them gives the model
    back."""
    flat = to_flax_variables(model)
    return flat["params"], flat["batch_stats"]
