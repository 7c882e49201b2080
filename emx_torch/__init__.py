"""PyTorch/CUDA port of `emx`: the serving path and the denoiser's
training path.

Mirrors `emx/`'s layout (`data`, `nn`, `ops`, `serve`, `train`,
`utils`). Imports torch, numpy and the standard library only: never JAX,
flax, ml_dtypes or the `emx` package. Activations are NHWC at every
public function, as in `emx`. Hand-written CUDA kernels live in `csrc/`
and are compiled with nvcc at first use (`emx_torch.ops._build`).
"""
