"""flax's default parameter initialisation for the port's modules.

The card's machine has no JAX to initialise with, so a model trained by
the port starts from this function of a `torch.Generator`, which draws
from the distributions flax's defaults draw from (not the same numbers):

  * conv and dense kernels: `lecun_normal`, a normal truncated at +-2
    standard deviations, scaled to std sqrt(1 / fan_in) / 0.8796...
    (the truncated unit normal's std), with fan_in = kh * kw * cin /
    groups (9 for a depthwise 3x3). A transposed conv's fan_in is 9 *
    cin, as flax computes it on its (3, 3, cin, cout) kernel;
  * biases zero, norm scales one, BatchNorm running mean 0 and var 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from emx_torch.nn.blocks import (BatchNorm, Conv, ConvTranspose, Dense,
                                 GroupNorm)

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]
_PHI = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # P(N(0, 1) < -2)


def truncated_normal_(t: torch.Tensor, std: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill `t` with N(0, std^2) truncated to [-2 std, 2 std], by the
    inverse CDF of uniforms drawn from `generator` (on the CPU)."""
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    x = torch.special.ndtri(_PHI + (1.0 - 2.0 * _PHI) * u).clamp(-2.0, 2.0)
    return t.copy_((x * std).to(t.dtype))


def _fan_in(mod: nn.Module) -> int:
    w = mod.weight
    if isinstance(mod, ConvTranspose):      # (cin, cout, 3, 3)
        return w.shape[0] * w.shape[2] * w.shape[3]
    if isinstance(mod, Conv):               # (cout, cin / groups, kh, kw)
        return w.shape[1] * w.shape[2] * w.shape[3]
    return w.shape[1]                       # nn.Linear: (out, in)


def init_parameters(model: nn.Module,
                    generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and BatchNorm statistic of `model` in
    place, module by module in registration order; returns `model`.
    Raises TypeError for a module with parameters of an unknown kind."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (Conv, ConvTranspose, nn.Linear)):
                std = math.sqrt(1.0 / _fan_in(mod)) / _TRUNC_STD
                truncated_normal_(mod.weight, std, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Dense):            # kernel (in, out)
                std = math.sqrt(1.0 / mod.kernel.shape[0]) / _TRUNC_STD
                truncated_normal_(mod.kernel, std, generator)
                mod.bias.zero_()
            elif isinstance(mod, (GroupNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.mean.zero_()
                    mod.var.fill_(1.0)
            elif any(True for _ in mod.parameters(recurse=False)):
                raise TypeError(f"no initialiser for {name or 'the model'} "
                                f"({type(mod).__name__})")
    return model
