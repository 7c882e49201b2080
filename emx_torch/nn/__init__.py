from emx_torch.nn.autoencoder import (EmbedderConfig, SmallAEConfig,
                                      SmallAutoencoder, UnsupervisedEmbedder,
                                      XceptionAEConfig, XceptionAutoencoder,
                                      embedder_metric_loss)
from emx_torch.nn.blocks import (ASPP, ConvBlock, DeconvBlock, Norm,
                                 SepConvBlock, XceptionMiddleBlock, relu6)
from emx_torch.nn.denoiser import Denoiser, DenoiserConfig
from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                    MultiscaleDiscriminator,
                                    multiscale_crops)
from emx_torch.nn.kernels import KernelBank, KernelStack, SymmetricKernel
from emx_torch.nn.latent import LatentAEConfig, LatentAutoencoder
from emx_torch.nn.manifold import ManifoldConfig, SharedManifoldTranslator
from emx_torch.nn.profiles import ProfileMLP, ProfileMLPConfig
from emx_torch.nn.style import (RestyleNet, StyleTransferConfig,
                                transfer_style)
from emx_torch.nn.vaegan import NestedVAEGAN, SpectralCritic, VAEGANConfig

__all__ = ["ASPP", "ConvBlock", "DeconvBlock", "Denoiser", "DenoiserConfig",
           "EmbedderConfig", "InfillingConfig", "InfillingGenerator",
           "KernelBank", "KernelStack", "LatentAEConfig",
           "LatentAutoencoder", "ManifoldConfig", "MultiscaleDiscriminator",
           "NestedVAEGAN", "Norm", "ProfileMLP", "ProfileMLPConfig",
           "RestyleNet", "SepConvBlock", "SharedManifoldTranslator",
           "SmallAEConfig", "SmallAutoencoder", "SpectralCritic",
           "StyleTransferConfig", "SymmetricKernel", "UnsupervisedEmbedder",
           "VAEGANConfig", "XceptionAEConfig", "XceptionAutoencoder",
           "XceptionMiddleBlock", "embedder_metric_loss", "multiscale_crops",
           "relu6", "transfer_style"]
