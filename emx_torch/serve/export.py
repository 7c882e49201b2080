"""Directory artifacts, the deployment seam (port of emx/serve/export.py).

An artifact is a directory in emx's own format:
  artifact.json   model class name, config, format, framework version
  params.msgpack  the variables as flax's `serialization.to_bytes`
                  writes them (emx_torch.serve.msgpack_codec)
A directory emx writes loads here and the reverse. `load_artifact`
rebuilds the model from the registered zoo (`register_model`) and
`Artifact.apply_fn` returns a ready function on a device.

`export_compiled` / `load_compiled` are the frozen-graph pair on
`torch.export` (a `module.pt2` file); emx's StableHLO file is not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from emx_torch.nn.denoiser import Denoiser, DenoiserConfig
from emx_torch.serve import msgpack_codec
from emx_torch.serve.convert import load_flax_params
from emx_torch.utils.device import resolve_device

_MODEL_REGISTRY: dict[str, Callable[[dict], nn.Module]] = {}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def register_model(name: str):
    """Decorator: register a `(config_dict) -> torch module` factory. The
    module is built on the CPU with empty parameters."""

    def deco(factory):
        _MODEL_REGISTRY[name] = factory
        return factory

    return deco


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _float32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


@dataclasses.dataclass
class Artifact:
    model_name: str
    config: dict
    variables: Any

    def module(self, device: str | torch.device = "cuda") -> nn.Module:
        """The registered model with the artifact's parameters, in eval
        mode on `device`."""
        device = resolve_device(device)
        model = _MODEL_REGISTRY[self.model_name](self.config)
        params = {k: _float32(v)
                  for k, v in _flat(self.variables["params"]).items()}
        load_flax_params(model, params)
        return model.to(device).eval().requires_grad_(False)

    def apply_fn(self, device: str | torch.device = "cuda"
                 ) -> Callable[[Any], torch.Tensor]:
        device = resolve_device(device)
        model = self.module(device)

        def apply(x):
            with torch.inference_mode():
                return model(torch.as_tensor(x).to(device))

        return apply


def _json_safe(value: Any) -> Any:
    """Config values JSON can round-trip (dtypes become names)."""
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, (int, float, str, bool, type(None))):
        return value
    return str(value)


def _sorted_tree(tree):
    """Dicts with sorted keys at every level, as emx's save_artifact
    leaves them (jax's tree_map sorts dict keys), so the same variables
    give the same bytes."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def nest(flat: dict) -> dict:
    """{"a/b/c": v} -> {"a": {"b": {"c": v}}}: flat flax dicts (as
    to_flax_params and read_artifact give them) as an artifact's trees."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def save_artifact(path: str, model_name: str, config: dict,
                  variables: Any) -> None:
    """Write `variables` (nested dicts of tensors or arrays, e.g.
    {"params": ...}) and `config` as a directory artifact."""
    os.makedirs(path, exist_ok=True)
    meta = {"model_name": model_name, "config": _json_safe(config),
            "format": "emx-artifact-v1", "torch_version": torch.__version__}
    with open(os.path.join(path, "artifact.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(msgpack_codec.packb(_sorted_tree(variables)))


def _restore(template: Any, state: Any, path: str = "") -> Any:
    """flax.serialization.from_state_dict on nested dicts: the template's
    keys taken from `state` (a key it lacks raises ValueError, keys it
    adds are dropped); leaves are the stored arrays."""
    if not isinstance(template, dict):
        return state
    if not isinstance(state, dict):
        raise ValueError(f"expected a dict at {path or '/'}, got "
                         f"{type(state).__name__}")
    missing = sorted(set(map(str, template)) - set(state))
    if missing:
        raise ValueError(f"the target dict keys {missing} are not present "
                         f"in the state dict at {path or '/'}")
    return {k: _restore(v, state[str(k)], f"{path}/{k}")
            for k, v in template.items()}


def load_artifact(path: str, template_variables: Any | None = None
                  ) -> Artifact:
    """Read a directory artifact. `template_variables` given: its nested
    dict structure is restored from the file, as flax's
    `serialization.from_bytes(template, blob)` does."""
    with open(os.path.join(path, "artifact.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        variables = msgpack_codec.unpackb(f.read())
    if template_variables is not None:
        variables = _restore(template_variables, variables)
    return Artifact(meta["model_name"], meta["config"], variables)


def export_compiled(path: str, module: nn.Module,
                    example_args: tuple) -> None:
    """Serialize `module` traced at `example_args` with torch.export to
    `path/module.pt2`: callers run it without the model code."""
    program = torch.export.export(module, example_args)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, "module.pt2"))


def load_compiled(path: str) -> Callable:
    """The module saved by `export_compiled`, as a callable."""
    return torch.export.load(os.path.join(path, "module.pt2")).module()


@register_model("denoiser")
def _make_denoiser(config: dict) -> nn.Module:
    fixed = {}
    for k, v in config.items():
        if k == "dtype":
            v = _DTYPES[v]
        elif isinstance(v, list):
            v = tuple(v)
        fixed[k] = v
    return Denoiser(DenoiserConfig(**fixed), device="cpu")
