"""Inference-graph optimization: BatchNorm folding (port of
emx/serve/optimize.py).

At inference BatchNorm is an affine map with frozen statistics, so it
folds exactly into the preceding convolution's kernel and bias:
    k' = k * gamma / sqrt(var + eps),   b' = beta + (b - mean) * gamma / sqrt(var + eps)
The folded model runs with norm='none' and equals the BatchNorm model in
eval mode up to float rounding.

The functions work, as emx's do, on flax-named parameters, here the flat
`{"A/B/Conv_1/kernel": array}` dicts of `emx_torch.serve.convert.
to_flax_params`, in float64, and cast the folded kernel and bias back to
their dtype. Structural contract: every `Norm_k` scope normalises the
output of the highest-numbered Conv/ConvTranspose/Dense sibling in its
parent scope, with at most one BatchNorm per scope.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_CONV = re.compile(r"(Conv|ConvTranspose|Dense)_(\d+)")
_NORM = re.compile(r"Norm_\d+")


def _scopes(params: dict[str, np.ndarray]) -> dict[str, set[str]]:
    """Scope path -> names of its child scopes."""
    children: dict[str, set[str]] = {}
    for key in params:
        parts = key.split("/")
        for i in range(len(parts) - 1):
            children.setdefault("/".join(parts[:i]), set()).add(parts[i])
    return children


def fold_batchnorm(params: dict[str, np.ndarray],
                   batch_stats: dict[str, np.ndarray],
                   eps: float = 1e-3) -> dict[str, np.ndarray]:
    """Fold every BatchNorm into its sibling conv. Returns the flat params
    of a norm='none' model (the folded Norm scopes removed). A BatchNorm
    without running statistics, or without a conv sibling, stays."""
    out = dict(params)
    for scope, names in _scopes(params).items():
        pre = f"{scope}/" if scope else ""
        norms = sorted(n for n in names if _NORM.fullmatch(n)
                       and f"{pre}{n}/BatchNorm_0/scale" in params)
        if len(norms) > 1:
            raise ValueError(
                "folding requires at most one BatchNorm per module scope "
                f"(found {norms} in {scope!r}); wrap each conv+norm pair in "
                "a block module (ConvBlock/SepConvBlock/DeconvBlock)")
        convs = [n for n in names if _CONV.fullmatch(n)]
        for nk in norms:
            bn = f"{pre}{nk}/BatchNorm_0"
            if f"{bn}/mean" not in batch_stats or not convs:
                continue
            ck = pre + max(convs, key=lambda n: int(_CONV.fullmatch(n)[2]))
            gamma = np.asarray(params[f"{bn}/scale"], np.float64)
            beta = np.asarray(params[f"{bn}/bias"], np.float64)
            mean = np.asarray(batch_stats[f"{bn}/mean"], np.float64)
            var = np.asarray(batch_stats[f"{bn}/var"], np.float64)
            scale = gamma / np.sqrt(var + eps)
            dtype = np.asarray(params[f"{ck}/kernel"]).dtype
            kernel = np.asarray(params[f"{ck}/kernel"], np.float64) * scale
            bias = np.asarray(params.get(f"{ck}/bias", np.zeros(scale.shape)),
                              np.float64)
            out[f"{ck}/kernel"] = kernel.astype(dtype)
            out[f"{ck}/bias"] = (beta + (bias - mean) * scale).astype(dtype)
            for key in [k for k in out if k.startswith(f"{pre}{nk}/")]:
                del out[key]
    return out


def fold_denoiser(config, params: dict[str, np.ndarray],
                  batch_stats: dict[str, np.ndarray]):
    """Fold a BatchNorm Denoiser into its norm='none' deployment twin.
    Returns (folded_config, folded flat params)."""
    if config.norm != "batch":
        raise ValueError("only BatchNorm models fold; GroupNorm is "
                         "data-dependent and cannot be folded")
    return (dataclasses.replace(config, norm="none"),
            fold_batchnorm(params, batch_stats))
