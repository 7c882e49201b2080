"""PyTorch/CUDA port of the `emx` serving path.

Mirrors `emx/`'s layout (`nn`, `ops`, `serve`, `utils`). Imports torch,
numpy and the standard library only: never JAX, flax, ml_dtypes or the
`emx` package. Activations are NHWC at every public function, as in
`emx`. Hand-written CUDA kernels live in `csrc/` and are compiled with
nvcc at first use (`emx_torch.ops._build`).
"""
