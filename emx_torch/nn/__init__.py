from emx_torch.nn.blocks import (ASPP, ConvBlock, DeconvBlock, SepConvBlock,
                                 XceptionMiddleBlock, relu6)
from emx_torch.nn.denoiser import Denoiser, DenoiserConfig

__all__ = ["ASPP", "ConvBlock", "DeconvBlock", "Denoiser", "DenoiserConfig",
           "SepConvBlock", "XceptionMiddleBlock", "relu6"]
