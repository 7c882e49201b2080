// Fused separable-conv block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel emx/ops/sepconv_kernel.py::fused_sepconv
// (body _sepconv_kernel). On NHWC bf16 activations, stride 1, rate 1, SAME
// zero padding, it computes with that kernel's roundings:
//
//   h   = bf16( sum over the 3x3 taps of f32(x) * dw, in f32, + dw_b )
//   out = bf16( clip( h @ bf16(pw) accumulated in f32 + pw_b, 0, 6 ) )
//
// The depthwise sum is taken tap by tap in (ky, kx) order with separate
// rounded multiplies and adds (no FMA contraction), as the plain PyTorch
// version does, so the bf16 intermediate h is bit-identical to it.
//
// What bounds it on this card: at the flagship's shapes (128x128 pixels,
// C in {16, 64, 80, 128}, Co in {64, 128}) one pixel costs 2*C*Co + 18*C
// operations against 2*(C + Co) bytes of HBM traffic, about 15 to 70
// operations per byte. That is far below the ~295 per byte at which the
// H100's bf16 tensor cores, and not its memory, set the limit, so the
// least time is set by bytes. The unfused pair of convs writes the
// depthwise result to device memory and reads it back, and the Pallas
// wrapper first makes a zero-padded copy of x. This kernel does neither:
// padding is a bounds check, and h lives only in shared memory.
//
// Design (first version: simple and right, not fast). One block per
// (image, row, tile of TP pixels along W, tile of TCO output channels).
// For each chunk of KC input channels the block computes the depthwise
// taps of its pixels straight from global memory, rounds them to bf16
// into shared memory, stages the matching pointwise weights (rounded to
// bf16) beside them, and accumulates the product in f32 registers with
// CUDA-core FMAs: 4 pixels x 4 output channels per thread. Ragged W, C
// and Co are masked. The pointwise product on CUDA cores, and the
// depthwise taps recomputed for every output-channel tile, keep this
// version above the byte bound; wgmma, TMA and a persistent schedule are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TP = 64;       // pixels along W per block
constexpr int TCO = 64;      // output channels per block
constexpr int KC = 32;       // input channels per shared-memory chunk
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
sepconv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dw,
                    const float* __restrict__ dwb,
                    const float* __restrict__ pw,
                    const float* __restrict__ pwb,
                    __nv_bfloat16* __restrict__ out,
                    int H, int W, int C, int Co, int co_tiles) {
  __shared__ float hs[TP][KC + 1];
  __shared__ float ws[KC][TCO];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx + 16 j
  const int ty = tid / 16;  // pixels ty + 16 i
  const int x0 = blockIdx.x * TP;
  const int y = blockIdx.y;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * TCO;
  const size_t image = static_cast<size_t>(b) * H * W;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    // Depthwise 3x3 of TP pixels x KC channels; lanes walk channels, so
    // a warp reads 32 neighbouring bf16 values of one pixel.
    for (int e = tid; e < TP * KC; e += THREADS) {
      const int c = e % KC, p = e / KC;
      const int ci = c0 + c, px = x0 + p;
      float v = 0.f;
      if (ci < C && px < W) {
        float s = 0.f;
        for (int ky = 0; ky < 3; ++ky) {
          const int yy = y + ky - 1;
          for (int kx = 0; kx < 3; ++kx) {
            const int xx = px + kx - 1;
            float xv = 0.f;
            if (yy >= 0 && yy < H && xx >= 0 && xx < W)
              xv = __bfloat162float(
                  x[(image + static_cast<size_t>(yy) * W + xx) * C + ci]);
            s = __fadd_rn(s, __fmul_rn(xv, dw[(ky * 3 + kx) * C + ci]));
          }
        }
        v = __bfloat162float(__float2bfloat16(__fadd_rn(s, dwb[ci])));
      }
      hs[p][c] = v;
    }
    // Pointwise weights of this chunk, rounded to the activation dtype.
    for (int e = tid; e < KC * TCO; e += THREADS) {
      const int o = e % TCO, c = e / TCO;
      const int ci = c0 + c, co = co0 + o;
      float w = 0.f;
      if (ci < C && co < Co)
        w = __bfloat162float(
            __float2bfloat16(pw[static_cast<size_t>(ci) * Co + co]));
      ws[c][o] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int px = x0 + ty + 16 * i;
    if (px >= W) continue;
    const size_t row = (image + static_cast<size_t>(y) * W + px) * Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co >= Co) continue;
      float v = acc[i][j] + pwb[co];
      v = v < 0.f ? 0.f : (v > 6.f ? 6.f : v);  // relu6; NaN passes
      out[row + co] = __float2bfloat16(v);
    }
  }
}

}  // namespace

// x (B, H, W, C) bf16; dw (3, 3, C) f32; dw_b (C) f32; pw (C, Co) f32;
// pw_b (Co) f32; out (B, H, W, Co) bf16. All contiguous, on one device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" cudaError_t emx_sepconv_bf16(const void* x, const void* dw,
                                        const void* dw_b, const void* pw,
                                        const void* pw_b, void* out, int B,
                                        int H, int W, int C, int Co,
                                        cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0)
    return cudaErrorInvalidValue;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const long long z = static_cast<long long>(B) * co_tiles;
  if (H > 65535 || z > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((W + TP - 1) / TP, H, static_cast<unsigned>(z));
  sepconv_bf16_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dw),
      static_cast<const float*>(dw_b), static_cast<const float*>(pw),
      static_cast<const float*>(pw_b), static_cast<__nv_bfloat16*>(out), H,
      W, C, Co, co_tiles);
  return cudaGetLastError();
}
