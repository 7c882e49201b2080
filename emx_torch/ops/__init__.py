"""The port's hand-written CUDA kernels. Importing the package builds
nothing: a kernel is compiled at its first launch on a card."""

from emx_torch.ops.degrade_kernel import fused_poisson_degrade

__all__ = ["fused_poisson_degrade"]
