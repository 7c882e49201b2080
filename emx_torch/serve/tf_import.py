"""TF1 checkpoint -> flax-named parameters for the port's denoiser (port
of emx/serve/tf_import.py; numpy only).

A deterministic mapping from the TF1 variable names the reference
trainer creates (misc_py/denoiser-multi-gpu.py architecture(): 200-540
under `tf.variable_scope('nn')`, denoiser-multi-gpu.py:680) to the flax
parameter tree, which the port's Denoiser keeps by name, plus the
layout and affine transforms. The repository holds no TF checkpoint:
the mapping is held on synthetic TF-named dicts.

TF1 naming assumptions (the only unverifiable part):
  * tf.layers.conv2d           -> scope 'conv2d', 'conv2d_1', ... in
    creation order; variables kernel/bias. Explicitly named ASPP convs
    ('1x1', 'lowRate', 'mediumRate', 'highRate', 'imageLevel',
    'pellet', denoiser-multi-gpu.py:296-358) do not consume the counter.
  * tf.layers.conv2d_transpose -> 'conv2d_transpose', ... ;
    kernel layout (kh, kw, OUT, IN) (transposed vs flax).
  * slim.separable_convolution2d -> 'SeparableConv2d', ... with
    variables depthwise_weights (kh, kw, IN, 1) and pointwise_weights;
    no biases (normalizer_fn is set, :262); the normalizer BatchNorm
    lives INSIDE the scope as '<scope>/BatchNorm'.
  * tf.contrib.layers.batch_norm (batch_then_activ, :210-223) ->
    'BatchNorm', 'BatchNorm_1', ... at 'nn' scope level; variables
    gamma/beta/moving_mean/moving_variance; epsilon 1e-3.

Structural transforms:
  * Separable blocks carry TWO BatchNorms in the reference (the slim
    normalizer + batch_then_activ, :262+273); SepConvBlock has one. At
    import the two affines (frozen stats) compose exactly into the
    single BN (mean'=0, var'=1-eps, scale'=a1*a2, bias'=a2*c1+c2).
  * Import config must be the TF-shaped graph: space_to_depth=1,
    aspp_separable=False, upsample='transpose', norm='batch', no extra
    heads: `tf_compat_config()` builds it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from emx_torch.utils.device import resolve_device

EPS = 1e-3


def tf_compat_config(features=(64, 128, 256, 728, 728),
                     num_middle_blocks: int = 11, aspp_out: int = 256):
    """The DenoiserConfig matching the TF reference graph 1:1."""
    from emx_torch.nn.denoiser import DenoiserConfig

    return DenoiserConfig(
        features=tuple(features), num_middle_blocks=num_middle_blocks,
        aspp_filters=features[4], aspp_out=aspp_out, aspp_rates=(6, 12, 18),
        norm="batch", aspp_separable=False, upsample="transpose",
        space_to_depth=1, full_res_head=0, mid_res_head=0,
        kernel_pred_head=0, folded_head=0,
    )


class _Namer:
    """TF1 per-type auto-uniquification: first use is bare, then _1…"""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def __call__(self, base: str) -> str:
        n = self.counts.get(base, 0)
        self.counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


def denoiser_tf1_mapping(config=None) -> list[dict[str, Any]]:
    """Ordered records pairing TF1 scopes with flax paths.

    Record kinds:
      sep    — SeparableConv2d (+ inner BN) + outer BN
               flax: SepConvBlock {Conv_0 depthwise, Conv_1 pointwise,
               Norm_0/BatchNorm_0}
      conv   — conv2d + outer BN -> ConvBlock
      deconv — conv2d_transpose + outer BN -> DeconvBlock
      raw_conv/raw_bn — bare conv / bare BN inside ASPP
    """
    config = config or tf_compat_config()
    nm = _Namer()
    recs: list[dict[str, Any]] = []

    def sep(flax):
        s = nm("SeparableConv2d")
        recs.append({"kind": "sep", "tf": f"nn/{s}",
                     "tf_outer_bn": f"nn/{nm('BatchNorm')}",
                     "flax": flax})

    def conv(flax, tf_name=None):
        c = f"nn/{tf_name}" if tf_name else f"nn/{nm('conv2d')}"
        recs.append({"kind": "conv", "tf": c,
                     "tf_outer_bn": f"nn/{nm('BatchNorm')}",
                     "flax": flax})

    def deconv(flax):
        recs.append({"kind": "deconv", "tf": f"nn/{nm('conv2d_transpose')}",
                     "tf_outer_bn": f"nn/{nm('BatchNorm')}",
                     "flax": flax})

    D = "Denoiser"  # top scope is the module itself; paths are relative
    si = ci = di = 0  # flax per-type counters inside the Denoiser scope

    def S():
        nonlocal si
        p = (f"SepConvBlock_{si}",)
        si += 1
        return p

    def C():
        nonlocal ci
        p = (f"ConvBlock_{ci}",)
        ci += 1
        return p

    def Dc():
        nonlocal di
        p = (f"DeconvBlock_{di}",)
        di += 1
        return p

    # Encoder blocks 0-3 (denoiser-multi-gpu.py:394-452).
    for _ in range(4):
        sep(S())
        sep(S())
        sep(S())          # strided
        conv(C())         # residual_conv
    # Encoder block 4 (:454-466).
    sep(S())
    sep(S())
    sep(S())
    # Middle blocks (:468-469).
    for i in range(config.num_middle_blocks):
        for j in range(3):
            sep((f"XceptionMiddleBlock_{i}", f"SepConvBlock_{j}"))
    # ASPP (:291-361): named convs; our ASPP scope is ASPP_0.
    conv(("ASPP_0", "ConvBlock_0"), tf_name="1x1")
    for b, tf_name in enumerate(("lowRate", "mediumRate", "highRate")):
        recs.append({"kind": "raw_conv", "tf": f"nn/{tf_name}",
                     "flax": ("ASPP_0", f"Conv_{b}")})
        recs.append({"kind": "raw_bn", "tf": f"nn/{nm('BatchNorm')}",
                     "flax": ("ASPP_0", f"Norm_{b}")})
    recs.append({"kind": "raw_conv", "tf": "nn/imageLevel",
                 "flax": ("ASPP_0", "Conv_3")})
    recs.append({"kind": "raw_bn", "tf": f"nn/{nm('BatchNorm')}",
                 "flax": ("ASPP_0", "Norm_3")})
    conv(("ASPP_0", "ConvBlock_1"), tf_name="pellet")
    # Decoder (:477-533): two skip stages + refinement + head.
    for _ in range(2):
        sep(S())
        sep(S())
        conv(C())         # 1x1 residual (conv_block_not_sep)
        deconv(Dc())
    sep(S())
    sep(S())
    conv(C())             # 1x1 residual
    conv(C())             # final head conv_block_not_sep(…, 1) 3x3
    return recs


def _bn_affine(g, b, m, v):
    a = g / np.sqrt(v + EPS)
    return a, b - a * m


def _compose_bns(inner: dict, outer: dict):
    a1, c1 = _bn_affine(*inner)
    a2, c2 = _bn_affine(*outer)
    return a1 * a2, a2 * c1 + c2


def _bn_get(tf_vars, scope):
    return tuple(
        np.asarray(tf_vars[f"{scope}/{n}"], np.float64)
        for n in ("gamma", "beta", "moving_mean", "moving_variance"))


def import_tf1_checkpoint(tf_vars: dict[str, np.ndarray],
                          config=None) -> dict:
    """Build Denoiser variables {"params": tree, "batch_stats": tree}
    (nested dicts of float32 numpy, flax's tree) from {tf_name: array}
    (as produced by tf.train.load_checkpoint reader dumps); `flat_variables`
    of it feeds emx_torch.serve.convert.load_flax_params."""
    config = config or tf_compat_config()
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    def put_bn(flax, a, c):
        # Single-BN equivalent of a frozen affine: mean 0, var 1-EPS.
        base = flax + ("Norm_0", "BatchNorm_0")
        put(params, base + ("scale",), np.asarray(a, np.float32))
        put(params, base + ("bias",), np.asarray(c, np.float32))
        put(stats, base + ("mean",), np.zeros_like(a, dtype=np.float32))
        put(stats, base + ("var",),
            np.full_like(a, 1.0 - EPS, dtype=np.float32))

    for r in recs_cache(config):
        flax, tf = r["flax"], r["tf"]
        if r["kind"] == "sep":
            dw = np.asarray(tf_vars[f"{tf}/depthwise_weights"])
            # TF depthwise (kh, kw, IN, mult=1) -> flax grouped-conv
            # kernel (kh, kw, 1, IN).
            put(params, flax + ("Conv_0", "kernel"),
                np.transpose(dw, (0, 1, 3, 2)).astype(np.float32))
            put(params, flax + ("Conv_1", "kernel"),
                np.asarray(tf_vars[f"{tf}/pointwise_weights"], np.float32))
            # flax Conv has biases; TF slim sep-conv has none -> zeros.
            cin = dw.shape[2]
            cout = np.asarray(tf_vars[f"{tf}/pointwise_weights"]).shape[-1]
            put(params, flax + ("Conv_0", "bias"),
                np.zeros((cin,), np.float32))
            put(params, flax + ("Conv_1", "bias"),
                np.zeros((cout,), np.float32))
            a, c = _compose_bns(_bn_get(tf_vars, f"{tf}/BatchNorm"),
                                _bn_get(tf_vars, r["tf_outer_bn"]))
            put_bn(flax, a, c)
        elif r["kind"] in ("conv", "raw_conv"):
            # 'conv' maps to a ConvBlock (Conv_0 child); 'raw_conv' maps
            # to a bare nn.Conv whose flax path IS the conv scope.
            cpath = flax + ("Conv_0",) if r["kind"] == "conv" else flax
            put(params, cpath + ("kernel",),
                np.asarray(tf_vars[f"{tf}/kernel"], np.float32))
            put(params, cpath + ("bias",),
                np.asarray(tf_vars[f"{tf}/bias"], np.float32))
            if r["kind"] == "conv":
                g, b, m, v = _bn_get(tf_vars, r["tf_outer_bn"])
                base = flax + ("Norm_0", "BatchNorm_0")
                put(params, base + ("scale",), g.astype(np.float32))
                put(params, base + ("bias",), b.astype(np.float32))
                put(stats, base + ("mean",), m.astype(np.float32))
                put(stats, base + ("var",), v.astype(np.float32))
        elif r["kind"] == "raw_bn":
            g, b, m, v = _bn_get(tf_vars, tf)
            base = flax + ("BatchNorm_0",)
            put(params, base + ("scale",), g.astype(np.float32))
            put(params, base + ("bias",), b.astype(np.float32))
            put(stats, base + ("mean",), m.astype(np.float32))
            put(stats, base + ("var",), v.astype(np.float32))
        elif r["kind"] == "deconv":
            k = np.asarray(tf_vars[f"{tf}/kernel"])
            # TF conv2d_transpose kernel (kh, kw, OUT, IN) -> flax
            # ConvTranspose (kh, kw, IN, OUT).
            put(params, flax + ("ConvTranspose_0", "kernel"),
                np.transpose(k, (0, 1, 3, 2)).astype(np.float32))
            put(params, flax + ("ConvTranspose_0", "bias"),
                np.asarray(tf_vars[f"{tf}/bias"], np.float32))
            g, b, m, v = _bn_get(tf_vars, r["tf_outer_bn"])
            base = flax + ("Norm_0", "BatchNorm_0")
            put(params, base + ("scale",), g.astype(np.float32))
            put(params, base + ("bias",), b.astype(np.float32))
            put(stats, base + ("mean",), m.astype(np.float32))
            put(stats, base + ("var",), v.astype(np.float32))
    return {"params": params, "batch_stats": stats}


def recs_cache(config):
    return denoiser_tf1_mapping(config)


def export_tf1_vars(variables: dict, config=None) -> dict[str, np.ndarray]:
    """Inverse of import (for round-trip tests): emit a synthetic TF1
    var dict whose import reproduces the given model FUNCTION (BN
    affines are re-expressed, so trees differ but outputs match).
    `variables` is nested dicts, as import gives them (`nest` of
    to_flax_params' flat dicts gives them for a port model)."""
    config = config or tf_compat_config()
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def get(tree, path):
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node)

    out: dict[str, np.ndarray] = {}

    def exp_bn_identity(scope, n):
        out[f"{scope}/gamma"] = np.ones((n,), np.float32)
        out[f"{scope}/beta"] = np.zeros((n,), np.float32)
        out[f"{scope}/moving_mean"] = np.zeros((n,), np.float32)
        out[f"{scope}/moving_variance"] = np.full((n,), 1.0 - EPS,
                                                  np.float32)

    def exp_bn(scope, flax_base):
        out[f"{scope}/gamma"] = get(params, flax_base + ("scale",))
        out[f"{scope}/beta"] = get(params, flax_base + ("bias",))
        out[f"{scope}/moving_mean"] = get(stats, flax_base + ("mean",))
        out[f"{scope}/moving_variance"] = get(stats, flax_base + ("var",))

    for r in recs_cache(config):
        flax, tf = r["flax"], r["tf"]
        if r["kind"] == "sep":
            dw = get(params, flax + ("Conv_0", "kernel"))
            out[f"{tf}/depthwise_weights"] = np.transpose(dw, (0, 1, 3, 2))
            pw = get(params, flax + ("Conv_1", "kernel"))
            out[f"{tf}/pointwise_weights"] = pw
            exp_bn_identity(f"{tf}/BatchNorm", pw.shape[-1])
            exp_bn(r["tf_outer_bn"],
                   flax + ("Norm_0", "BatchNorm_0"))
        elif r["kind"] in ("conv", "raw_conv"):
            cpath = flax + ("Conv_0",) if r["kind"] == "conv" else flax
            out[f"{tf}/kernel"] = get(params, cpath + ("kernel",))
            out[f"{tf}/bias"] = get(params, cpath + ("bias",))
            if r["kind"] == "conv":
                exp_bn(r["tf_outer_bn"], flax + ("Norm_0", "BatchNorm_0"))
        elif r["kind"] == "raw_bn":
            exp_bn(tf, flax + ("BatchNorm_0",))
        elif r["kind"] == "deconv":
            k = get(params, flax + ("ConvTranspose_0", "kernel"))
            out[f"{tf}/kernel"] = np.transpose(k, (0, 1, 3, 2))
            out[f"{tf}/bias"] = get(params, flax + ("ConvTranspose_0",
                                                    "bias"))
            exp_bn(r["tf_outer_bn"], flax + ("Norm_0", "BatchNorm_0"))
    return out


def flat_variables(variables: dict
                   ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """(params, batch_stats) of import_tf1_checkpoint's output as flat
    "A/B/kernel" dicts, the form load_flax_params takes."""
    from emx_torch.serve.export import _flat

    return (_flat(variables["params"]),
            _flat(variables.get("batch_stats", {})))


def load_tf1_denoiser(tf_vars: dict[str, np.ndarray], config=None,
                      device="cuda"):
    """A port Denoiser built from a TF1 variable dict (on `device`)."""
    from emx_torch.nn.denoiser import Denoiser
    from emx_torch.serve.convert import load_flax_params

    config = config or tf_compat_config()
    model = Denoiser(config, device="cpu")
    load_flax_params(model, *flat_variables(
        import_tf1_checkpoint(tf_vars, config)))
    return model.to(resolve_device(device))
