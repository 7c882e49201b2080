from emx_torch.nn.blocks import (ASPP, ConvBlock, DeconvBlock, SepConvBlock,
                                 XceptionMiddleBlock, relu6)
from emx_torch.nn.denoiser import Denoiser, DenoiserConfig
from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                    MultiscaleDiscriminator,
                                    multiscale_crops)

__all__ = ["ASPP", "ConvBlock", "DeconvBlock", "Denoiser", "DenoiserConfig",
           "InfillingConfig", "InfillingGenerator", "MultiscaleDiscriminator",
           "SepConvBlock", "XceptionMiddleBlock", "multiscale_crops",
           "relu6"]
