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
// the 64-bit seed that the wrapper puts in device memory (the kernel reads
// it there, so that a CUDA graph of the train step can be replayed with a
// new seed copied in), the counter (element, image_offset + image); word
// 0 gives u, word 1 gives u2. The offset is the batch's first image in a
// larger batch: a data-parallel rank that degrades rows [k, k + B) of a
// global batch passes k and draws what a launch over the whole batch
// draws for those rows (0 for a batch of its own).
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
// float32 rate, so bytes set the bound, narrowly.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), no
// memsets. The batch is cut into items of TILE = 4096 elements of one
// image; a persistent grid, sized by the host from the occupancy query,
// gives each block `ipb` items a grid apart (items blockIdx.x,
// blockIdx.x + gridDim.x, ...), so that an SM's blocks hold tiles of
// many images (an element's cost depends on its image's dose: the CDF
// loop runs about `rate` terms).
// * Phase 1: each thread samples its 16 elements of an item, four Philox
//   chains at a time so that their latency overlaps, and writes the
//   counts to out. Each item's min and max are reduced in the warp and
//   the block and written to its own slot of a scratch buffer of 2 x
//   items floats: every slot is written, so nothing needs a memset.
// * grid.sync(). (No -rdc: since CUDA 12 cooperative groups' grid sync
//   needs no relocatable device code.)
// * Phase 2: for each item it holds, a block reduces the item partials
//   of its image, then each thread rescales in place the counts it wrote
//   itself (a (16, 512, 512) batch, 16.8 MB, fits in the 50 MB L2).
//   Keeping the counts in shared memory between the phases instead took
//   2% off the kernel's time on the card (PERF.md, §6) for a second
//   schedule; the kernel keeps one.
//
// What sets its time on the card is neither the bytes nor a fixed cost:
// the time grows with the elements and with the share of them below rate
// 10. The exact arithmetic (Philox's integer products, the correctly
// rounded divisions and square roots, logf and cosf) is issue-bound on
// the CUDA cores; the operation count in chip_smoke.py's bound counts
// each of those as one operation. On the card this one launch is slower
// than a counting kernel followed by a rescaling kernel (PERF.md, §6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;
constexpr int CHAINS = 4;                   // Philox chains in flight
constexpr int TILE = THREADS * PER_THREAD;  // elements per item
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

// Min and max over the block, returned to every thread.
__device__ __forceinline__ void block_minmax(float& lo, float& hi,
                                             float* red) {
  for (int off = 16; off; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = lo;
    red[WARPS + warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    lo = fminf(lo, red[w]);
    hi = fmaxf(hi, red[WARPS + w]);
  }
  __syncthreads();  // red may be written again
}

// At most 64 registers, so that 4 blocks (1,024 threads) fit on an SM.
__global__ void __launch_bounds__(THREADS, 4)
degrade_kernel(const float* __restrict__ imgs, const float* __restrict__ scales,
               float* __restrict__ out, float* __restrict__ part,
               long long hw, int tiles, long long items, int ipb,
               const unsigned long long* __restrict__ seed,
               unsigned image_offset) {
  __shared__ float red[2 * WARPS];
  // The Philox key is read from device memory, so a captured CUDA graph
  // draws a new stream on each replay from what was copied there.
  const unsigned long long key = *seed;
  const uint32_t key0 = static_cast<uint32_t>(key);
  const uint32_t key1 = static_cast<uint32_t>(key >> 32);

  // Phase 1: sample, write the counts, one (min, max) per item.
  for (int s = 0; s < ipb; ++s) {
    const long long item = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (item >= items) break;
    const unsigned b = static_cast<unsigned>(item / tiles);
    const long long e0 = (item % tiles) * TILE;
    const float scale = scales[b];
    const size_t base = static_cast<size_t>(b) * hw;
    float lo = __int_as_float(0x7F800000), hi = 0.0f;
    for (int g = 0; g < PER_THREAD; g += CHAINS) {
      Words r[CHAINS];
      float rate[CHAINS];
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        const long long e = e0 + (g + j) * THREADS + threadIdx.x;
        rate[j] = e < hw ? __fmul_rn(imgs[base + e], scale) : 0.0f;
        r[j] = philox4x32_10(Words{static_cast<uint32_t>(e),
                                   static_cast<uint32_t>(e >> 32),
                                   image_offset + b, 0u},
                             key0, key1);
      }
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        const int i = (g + j) * THREADS + threadIdx.x;
        if (e0 + i >= hw) continue;
        const float k = sample_count(rate[j], r[j].x, r[j].y);
        out[base + e0 + i] = k;
        lo = fminf(lo, k);
        hi = fmaxf(hi, k);
      }
    }
    block_minmax(lo, hi, red);
    if (threadIdx.x == 0) {
      part[item] = lo;
      part[items + item] = hi;
    }
  }

  cg::this_grid().sync();

  // Phase 2: per-image min and max from the item partials, then rescale.
  long long image = -1;
  float lo = 0.0f, span = 0.0f, inv = 0.0f;
  for (int s = 0; s < ipb; ++s) {
    const long long item = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (item >= items) break;
    const long long b = item / tiles;
    if (b != image) {  // the same for the whole block
      float l = __int_as_float(0x7F800000), h = 0.0f;
      for (int t = threadIdx.x; t < tiles; t += THREADS) {
        l = fminf(l, __ldcg(part + b * tiles + t));
        h = fmaxf(h, __ldcg(part + items + b * tiles + t));
      }
      block_minmax(l, h, red);
      image = b;
      lo = l;
      span = __fsub_rn(h, l);
      inv = span > 0.0f ? __fdiv_rn(1.0f, span) : 0.0f;
    }
    const long long e0 = (item % tiles) * TILE;
    float* o = out + static_cast<size_t>(b) * hw + e0;
    for (int i = threadIdx.x; i < TILE && e0 + i < hw; i += THREADS) {
      const float k = o[i];  // this thread's own count from phase 1
      o[i] = span > 0.0f ? __fmul_rn(__fsub_rn(k, lo), inv) : 0.5f;
    }
  }
}

}  // namespace

// Blocks of the kernel that fit on one SM, on the current device.
extern "C" cudaError_t emx_degrade_occupancy(int* blocks) {
  if (blocks == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, degrade_kernel,
                                                       THREADS, 0);
}

// imgs (B, H, W) f32, scales (B) f32, out (B, H, W) f32, part 2 x items
// f32 scratch (items = B x ceil(hw / 4096)); seed one u64 on the device,
// the 64-bit Philox key; image_offset the batch's first image in the
// Philox counter (offset + B must stay below 2^32); all contiguous, on
// one device; hw = H * W. ipb
// and grid are the wrapper's plan (degrade_plan). One cooperative launch
// on `stream` (CUDA 12 stream capture takes it into a graph as it is);
// returns the first error,
// cudaErrorCooperativeLaunchTooLarge if the grid cannot be co-resident.
extern "C" cudaError_t emx_poisson_degrade(const void* imgs, const void* scales,
                                           void* out, void* part, int B,
                                           long long hw, const void* seed,
                                           long long image_offset, int ipb,
                                           int grid, cudaStream_t stream) {
  if (B <= 0 || hw <= 0 || ipb <= 0 || grid <= 0 || seed == nullptr ||
      image_offset < 0 || image_offset + B > 0xFFFFFFFFLL)
    return cudaErrorInvalidValue;
  unsigned offset = static_cast<unsigned>(image_offset);
  const long long tiles_ll = (hw + TILE - 1) / TILE;
  if (tiles_ll > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  int tiles = static_cast<int>(tiles_ll);
  long long items = static_cast<long long>(B) * tiles;
  if (static_cast<long long>(grid) * ipb < items) return cudaErrorInvalidValue;
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = emx_degrade_occupancy(&per_sm);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || grid > per_sm * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  const float* im = static_cast<const float*>(imgs);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  const unsigned long long* sd = static_cast<const unsigned long long*>(seed);
  void* args[] = {&im, &sc, &o, &pt, &hw, &tiles, &items, &ipb, &sd,
                  &offset};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(degrade_kernel),
                                    dim3(grid), dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
