// Fused Poisson low-dose degrade for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel emx/ops/degrade_kernel.py:39
// (_degrade_kernel, with _uniform_from_bits :32), reached there through
// fused_poisson_degrade(use_pallas=True). For each image i of a (B, H, W)
// float32 batch with dose scales (B,):
//
//   rate   = img * scale_i
//   count  = Poisson(rate) by CDF inversion, min(rate, 15), 32 terms,
//            where rate < 10; else max(rint(rate + sqrt(rate) * z), 0),
//            z = sqrt(-2 log max(u, 1e-12)) * cos(2 pi u2) (Box-Muller)
//   out    = (count - min) / (max - min) per image; 0.5 if constant.
//
// Uniforms take 23 bits of a Philox4x32-10 word, as _uniform_from_bits
// does: [0, 1). The generator is written out below (no cuRAND): the key is
// the wrapper's 64-bit seed, the counter (element, image); word 0 gives u,
// word 1 gives u2.
//
// One deliberate divergence from the TPU kernel: its CDF loop starts at
// P(X = 0) but only compares from j = 1 on, so it draws max(X - 1, 0)
// (mean 0.107 at rate 0.5, 4.0 at rate 5). This kernel counts from j = 0
// and draws X ~ Poisson(rate), as emx's docstring and its statistical
// reference promise. The loop stops at the first j with u <= F(j); F only
// grows, so the count equals the full 32-term loop's.
//
// Every multiply, add and divide is written with a _rn intrinsic, so no
// FMA contraction happens and the plain PyTorch version in
// emx_torch/ops/degrade_kernel.py, which does the same operations in the
// same order, agrees element for element up to the last bit of expf,
// logf, cosf (sqrtf and the divisions are correctly rounded). Build
// without --use_fast_math.
//
// What bounds it: 4 bytes read and 4 written per element, 33.5 MB for a
// (16, 512, 512) batch, about 10 us at 3.35 TB/s; the Philox rounds and
// the sampler are roughly 130 operations per element, about 8 us at the
// float32 rate, so bytes set the bound, narrowly. Design: two passes over
// a grid of (tiles of 2048 elements, B), 128 blocks per 512x512 image, so
// a B = 16 batch spreads over all 132 SMs (one block per image would use
// 16). Pass 1 draws, samples and stores the counts, reduces min and max in
// the block and merges them with atomicMin / atomicMax on the float bits
// as unsigned (counts are >= +0, where that order is the float order).
// Pass 2 rescales in place. The cost of two passes: pass 2 reads and
// writes the batch once more (16 MB each way at B = 16, largely from the
// 50 MB L2), up to twice the byte bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;  // elements per block
constexpr int INV_TERMS = 32;

struct Words {
  uint32_t x, y, z, w;
};

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants).
__device__ __forceinline__ Words philox4x32_10(Words c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = Words{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// 23 mantissa bits -> [1, 2) -> [0, 1), as emx's _uniform_from_bits.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float sample_count(float rate, uint32_t bits0,
                                              uint32_t bits1) {
  const float u = uniform_from_bits(bits0);
  if (rate < 10.0f) {
    const float r = fminf(rate, 15.0f);
    float p = expf(-r);
    float cdf = p;
    float k = u > cdf ? 1.0f : 0.0f;  // j = 0 counts
    for (int j = 1; j < INV_TERMS && u > cdf; ++j) {
      p = __fdiv_rn(__fmul_rn(p, r), static_cast<float>(j));
      cdf = __fadd_rn(cdf, p);
      k = __fadd_rn(k, u > cdf ? 1.0f : 0.0f);
    }
    return k;
  }
  const float u2 = uniform_from_bits(bits1);
  const float radius = sqrtf(__fmul_rn(-2.0f, logf(fmaxf(u, 1e-12f))));
  const float z = __fmul_rn(radius, cosf(__fmul_rn(6.28318530718f, u2)));
  const float k =
      rintf(__fadd_rn(rate, __fmul_rn(sqrtf(fmaxf(rate, 0.0f)), z)));
  return k > 0.0f ? k : 0.0f;  // also maps -0 and NaN to +0
}

__global__ void __launch_bounds__(THREADS)
degrade_counts(const float* __restrict__ imgs, const float* __restrict__ scales,
               float* __restrict__ out, unsigned* __restrict__ lo_bits,
               unsigned* __restrict__ hi_bits, long long hw, uint32_t key0,
               uint32_t key1) {
  const unsigned b = blockIdx.y;
  const float scale = scales[b];
  const size_t base = static_cast<size_t>(b) * hw;
  float lo = __int_as_float(0x7F800000), hi = 0.0f;
  for (int i = 0; i < PER_THREAD; ++i) {
    const long long e = static_cast<long long>(blockIdx.x) * TILE +
                        i * THREADS + threadIdx.x;
    if (e >= hw) break;
    const float rate = __fmul_rn(imgs[base + e], scale);
    const Words r = philox4x32_10(
        Words{static_cast<uint32_t>(e), static_cast<uint32_t>(e >> 32), b, 0u},
        key0, key1);
    const float k = sample_count(rate, r.x, r.y);
    out[base + e] = k;
    lo = fminf(lo, k);
    hi = fmaxf(hi, k);
  }
  for (int off = 16; off; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, off));
  }
  __shared__ float warp_lo[THREADS / 32], warp_hi[THREADS / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      lo = fminf(lo, warp_lo[w]);
      hi = fmaxf(hi, warp_hi[w]);
    }
    atomicMin(lo_bits + b, __float_as_uint(lo));
    atomicMax(hi_bits + b, __float_as_uint(hi));
  }
}

__global__ void __launch_bounds__(THREADS)
degrade_rescale(float* __restrict__ out, const unsigned* __restrict__ lo_bits,
                const unsigned* __restrict__ hi_bits, long long hw) {
  const unsigned b = blockIdx.y;
  const float lo = __uint_as_float(lo_bits[b]);
  const float span = __fsub_rn(__uint_as_float(hi_bits[b]), lo);
  const float inv = span > 0.0f ? __fdiv_rn(1.0f, span) : 0.0f;
  const size_t base = static_cast<size_t>(b) * hw;
  for (int i = 0; i < PER_THREAD; ++i) {
    const long long e = static_cast<long long>(blockIdx.x) * TILE +
                        i * THREADS + threadIdx.x;
    if (e >= hw) break;
    out[base + e] =
        span > 0.0f ? __fmul_rn(__fsub_rn(out[base + e], lo), inv) : 0.5f;
  }
}

}  // namespace

// imgs (B, H, W) f32, scales (B) f32, out (B, H, W) f32, minmax (2, B)
// 32-bit scratch; all contiguous, on one device; hw = H * W. Launches on
// `stream` (scratch init, counts, rescale) and returns the first error.
extern "C" cudaError_t emx_poisson_degrade(const void* imgs, const void* scales,
                                           void* out, void* minmax, int B,
                                           long long hw,
                                           unsigned long long seed,
                                           cudaStream_t stream) {
  if (B <= 0 || hw <= 0) return cudaErrorInvalidValue;
  const long long tiles = (hw + TILE - 1) / TILE;
  if (B > 65535 || tiles > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  unsigned* lo = static_cast<unsigned*>(minmax);
  unsigned* hi = lo + B;
  // min starts above every count's bits, max at +0.
  cudaError_t err = cudaMemsetAsync(lo, 0xFF, sizeof(unsigned) * B, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(hi, 0, sizeof(unsigned) * B, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), B);
  float* o = static_cast<float*>(out);
  degrade_counts<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(scales), o,
      lo, hi, hw, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  degrade_rescale<<<grid, THREADS, 0, stream>>>(o, lo, hi, hw);
  return cudaGetLastError();
}
