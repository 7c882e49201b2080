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
// reference promise. The loop stops at the first j with u <= F(j), which
// gives the full 32-term loop's count.
//
// Every multiply and add is written with a _rn intrinsic, so no FMA
// contraction happens and the plain PyTorch version in
// emx_torch/ops/degrade_kernel.py, which does the same operations in the
// same order, agrees element for element up to the last bit of expf,
// logf, cosf (sqrtf and the divisions are correctly rounded). The CDF
// term's division by j is correctly rounded without a divide instruction
// (div_by_term); an exhaustive check over every float (emx_degrade_
// division_mismatches) holds it to __fdiv_rn. Build without
// --use_fast_math.
//
// What bounds it: 4 bytes read and 4 written per element, 33.5 MB for a
// (16, 512, 512) batch, 10 us at 3.35 TB/s. Philox's 54 integer
// operations an element issue at the INT32 rate (64 lanes a clock an
// SM), which alone takes 14 us for that batch: operations bind
// (chip_smoke.py's degrade_bound_ms counts each unit at its own rate).
// On the card the counting kernel issues Philox, Box-Muller's exact
// logf, cosf and sqrtf, and the CDF loop's bookkeeping at about half the
// issue rate; PERF.md section 6 has the measured split.
//
// Design: a memset and two kernels on one stream, no grid-wide sync.
// * 3 x B words are zeroed by cudaMemsetAsync: per image (min, max) and
//   a tally of its finished counting blocks. Counts are never negative
//   (sample_large maps -0 and NaN to +0, the CDF count starts at +0), so
//   for them the order of the uint32 bits is the order of the floats,
//   +inf included: the max is an atomicMax of the bits, the min an
//   atomicMax of the complemented bits (0 stands above every count).
//   Exact, and in no order.
// * count_kernel: a non-persistent grid of one block per TILE elements of
//   one image; the hardware hands a finished SM the next block, so tiles
//   of a dose-25 image (up to three times the cost of a dose-400 one)
//   balance. The counts go straight to `out`, each thread keeping the
//   min and max of those it wrote.
//   1. A uniform pass: each thread draws the Philox words and the rate of
//      its 8 elements, four chains in flight. Where two of a warp's
//      groups of 32 hold no rate below 10 (most of a dose-100 image),
//      Box-Muller samples both there, side by side. Any other group is
//      sorted into two lists in shared memory (warp ballot and popcount,
//      one shared atomic per warp and list for four groups): rate < 10
//      from the front, the rest from the back.
//   2. A uniform pass over both lists: Box-Muller for the large entries,
//      two a thread at a time; P(X = 0) = exp(-r) for the small ones.
//   3. The small list drains in slices of at least DRAIN_SLICE entries, a
//      warp a slice, with per-lane refill: a lane whose CDF loop has
//      ended stores its count, takes the entry it loaded ahead and loads
//      the next (the warp's ballot and popcount hand out the slots); the
//      warp takes DRAIN_TERMS terms a round while any lane has work. The
//      old kernel's warps ran the loop until their slowest lane ended and
//      then Box-Muller, both in every warp holding both kinds.
//   4. The block's (min, max) to the image's words, one atomic each.
//   Shared memory: a 16-byte list entry an element, 33 KB a block, so
//   five blocks (at most 48 registers) fit on an SM.
// * rescale_kernel, launched with programmatic dependent launch
//   (cudaLaunchAttributeProgrammaticStreamSerialization): its grid is
//   launched once every counting block has started; a block waits for
//   its image's tally to reach the image's counting blocks (an acquire
//   load against the counting blocks' fence and atomic), then rescales
//   its span of `out` in place, the counts read back from the L2 (a (16,
//   512, 512) batch, 16.8 MB, fits in its 50 MB). The spans of the
//   images finished first are rescaled while the counting grid's last
//   blocks still run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;
constexpr int CHAINS = 4;                   // Philox chains in flight
constexpr int TILE = THREADS * PER_THREAD;  // elements of one image a block
constexpr int INV_TERMS = 32;
constexpr int MIN_BLOCKS = 5;               // blocks an SM: at most 48 regs
constexpr int DRAIN_TERMS = 4;              // CDF terms a drain round
constexpr int DRAIN_SLICE = 64;             // least small entries a warp
constexpr int RESCALE_THREADS = 256;
constexpr int RESCALE_TILE = 16384;         // elements a rescale block
constexpr unsigned FULL = 0xFFFFFFFFu;

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

// RN(x / j) for j in [1, 31], given fj = j and y = RN(1 / j): q = RN(x y)
// is within an ulp of x / j, the residual r = x - q j is exact in one
// fma, and RN(q + r y) is the correctly rounded quotient (Markstein),
// away from underflow and overflow: for |x| in [2^-100, FLT_MAX]
// (div_fast_exact). For a power of two y is exact and q already is.
// Elsewhere (subnormal quotients, zero, inf, NaN) div_by_term divides.
// emx_degrade_division_mismatches checks div_by_term against __fdiv_rn on
// all 2^32 floats for every j.
__device__ __forceinline__ bool div_fast_exact(float x) {
  const float ax = fabsf(x);
  return ax >= 0x1p-100f && ax <= 0x1.fffffep127f;
}

__device__ __forceinline__ float div_fast(float x, float fj, float y) {
  const float q = __fmul_rn(x, y);
  return __fmaf_rn(__fmaf_rn(-q, fj, x), y, q);
}

__device__ __forceinline__ float div_by_term(float x, float fj, float y) {
  return div_fast_exact(x) ? div_fast(x, fj, y) : __fdiv_rn(x, fj);
}

// rate >= 10 (or NaN): the normal approximation.
__device__ __forceinline__ float sample_large(float rate, float u, float u2) {
  const float radius = sqrtf(__fmul_rn(-2.0f, logf(fmaxf(u, 1e-12f))));
  const float z = __fmul_rn(radius, cosf(__fmul_rn(6.28318530718f, u2)));
  const float k =
      rintf(__fadd_rn(rate, __fmul_rn(sqrtf(fmaxf(rate, 0.0f)), z)));
  return k > 0.0f ? k : 0.0f;  // also maps -0 and NaN to +0
}

// A count to `out` (a block's tile), and into its thread's min and max.
__device__ __forceinline__ void put(float* dst, int i, float k, float& lo,
                                    float& hi) {
  dst[i] = k;
  lo = fminf(lo, k);
  hi = fmaxf(hi, k);
}

__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A list entry: (u, rate, u2 for a large rate or exp(-rate) for a small
// one, the element's index in the tile as int bits).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
count_kernel(const float* __restrict__ imgs, const float* __restrict__ scales,
             float* __restrict__ out, unsigned* __restrict__ minmax,
             long long hw, int tiles,
             const unsigned long long* __restrict__ seed,
             unsigned image_offset) {
  __shared__ float4 entry[TILE];
  // (j, RN(1 / j)); rows past 31 are read ahead of a loop's end, unused.
  __shared__ float2 term[2 * INV_TERMS];
  __shared__ float red[2 * WARPS];
  __shared__ int n_small, n_large;

  // The rescale grid may launch once every block of this grid has got
  // here; its blocks wait on their images' tallies.
  grid_launch_dependents();

  const unsigned b = blockIdx.x / tiles;
  const long long e0 = static_cast<long long>(blockIdx.x % tiles) * TILE;
  const int n = static_cast<int>(min(static_cast<long long>(TILE), hw - e0));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x < 2 * INV_TERMS) {
    const float fj = static_cast<float>(threadIdx.x);
    term[threadIdx.x] = make_float2(fj, __frcp_rn(fj));
  }
  if (threadIdx.x == 0) {
    n_small = 0;
    n_large = 0;
  }
  // The Philox key is read from device memory, so a captured CUDA graph
  // draws a new stream on each replay from what was copied there.
  const unsigned long long key = *seed;
  const uint32_t key0 = static_cast<uint32_t>(key);
  const uint32_t key1 = static_cast<uint32_t>(key >> 32);
  const float scale = scales[b];
  const size_t base = static_cast<size_t>(b) * hw + e0;
  const float* src = imgs + base;
  float* dst = out + base;
  float lo = __int_as_float(0x7F800000), hi = 0.0f;  // of this thread's counts
  __syncthreads();

  // 1. Draw every element's words and rate. Where two of a warp's groups
  // of 32 elements hold no rate below 10, Box-Muller samples them here,
  // side by side, every lane on the same path; the others go to the
  // lists. The counts go to `out`, their min and max to lo and hi.
#pragma unroll 1
  for (int g = 0; g < PER_THREAD; g += CHAINS) {
    Words w[CHAINS];
    float rate[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const int i = (g + c) * THREADS + threadIdx.x;
      rate[c] = i < n ? __fmul_rn(src[i], scale) : 0.0f;
      // The element's index fits in word 0 (hw < 2^32), so word 1 is 0
      // and the first round's image product is the same for the block.
      w[c] = philox4x32_10(Words{static_cast<uint32_t>(e0) + i, 0u,
                                 image_offset + b, 0u},
                           key0, key1);
    }
    unsigned small[CHAINS], large[CHAINS];
    int n_s = 0, n_l = 0;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const bool valid = (g + c) * THREADS + threadIdx.x < n;
      small[c] = __ballot_sync(FULL, valid && rate[c] < 10.0f);
      large[c] = __ballot_sync(FULL, valid && !(rate[c] < 10.0f));
      n_s += __popc(small[c]);
    }
#pragma unroll
    for (int c0 = 0; c0 < CHAINS; c0 += 2) {
      if (!(small[c0] | small[c0 + 1])) large[c0] = large[c0 + 1] = 0u;
      n_l += __popc(large[c0]) + __popc(large[c0 + 1]);
    }
    int s0 = 0, l0 = 0;
    if (lane == 0) {
      s0 = atomicAdd(&n_small, n_s);
      l0 = atomicAdd(&n_large, n_l);
    }
    s0 = __shfl_sync(FULL, s0, 0);
    l0 = __shfl_sync(FULL, l0, 0);
#pragma unroll
    for (int c0 = 0; c0 < CHAINS; c0 += 2) {
      const int i = (g + c0) * THREADS + threadIdx.x;
      if (!(small[c0] | small[c0 + 1])) {
        const float ka = sample_large(rate[c0], uniform_from_bits(w[c0].x),
                                      uniform_from_bits(w[c0].y));
        const float kb =
            sample_large(rate[c0 + 1], uniform_from_bits(w[c0 + 1].x),
                         uniform_from_bits(w[c0 + 1].y));
        if (i < n) put(dst, i, ka, lo, hi);
        if (i + THREADS < n) put(dst, i + THREADS, kb, lo, hi);
        continue;
      }
#pragma unroll
      for (int c = c0; c < c0 + 2; ++c) {
        const bool is_small = (small[c] >> lane) & 1u;
        const int slot = is_small ? s0 + __popc(small[c] & below)
                                  : n - 1 - (l0 + __popc(large[c] & below));
        if (is_small || ((large[c] >> lane) & 1u))
          entry[slot] = make_float4(uniform_from_bits(w[c].x), rate[c],
                                    uniform_from_bits(w[c].y),
                                    __int_as_float(i + (c - c0) * THREADS));
        s0 += __popc(small[c]);
        l0 += __popc(large[c]);
      }
    }
  }
  __syncthreads();
  // Entries [0, ns) small, [n - nl, n) large.
  const int ns = n_small, nl = n_large;

  // 2. Box-Muller over the large list, two entries a thread at a time so
  // that their chains overlap; exp(-rate) over the small one (rate < 10,
  // so min(rate, 15) is the rate).
  for (int s = n - nl + threadIdx.x; s < n; s += 2 * THREADS) {
    // Past the end, the last entry again: its count written twice.
    const int s2 = min(s + THREADS, n - 1);
    const float4 a = entry[s], c = entry[s2];
    const float ka = sample_large(a.y, a.x, a.z);
    const float kc = sample_large(c.y, c.x, c.z);
    put(dst, __float_as_int(a.w), ka, lo, hi);
    put(dst, __float_as_int(c.w), kc, lo, hi);
  }
  for (int s = threadIdx.x; s < ns; s += THREADS)
    entry[s].z = expf(-entry[s].y);
  __syncthreads();

  // 3. Drain the small list, in slices of at least DRAIN_SLICE entries
  // (fewer warps, each with fewer rounds at the slice's end with idle
  // lanes). A lane holds one element's CDF loop (j terms taken) and the
  // next entry, loaded ahead; when its loop has ended it stores the
  // count, takes that entry and loads another. DRAIN_TERMS terms a round
  // between the warp's votes, each with the multiply-path division; a
  // round where a lane left [2^-100, FLT_MAX] is redone for it with
  // div_by_term.
  const int drainers = max(1, min(WARPS, ns / DRAIN_SLICE));
  if (warp < drainers) {
    int cursor = ns * warp / drainers;  // warp-uniform
    const int end = ns * (warp + 1) / drainers;
    int idx = -1, j = 0, alive = 0, ahead = 0;  // alive: another term due
    float u = 0.0f, r = 0.0f, p = 0.0f, cdf = 0.0f;
    float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (;;) {
      if (!alive) {
        if (idx >= 0)  // ended: at j < 31 by u <= F(j), else at 31 terms
          put(dst, idx,
              u > cdf ? static_cast<float>(INV_TERMS) : static_cast<float>(j),
              lo, hi);
        idx = -1;
        if (ahead) {
          u = next.x;
          r = next.y;
          p = cdf = next.z;
          j = 0;
          idx = __float_as_int(next.w);
          alive = u > cdf;  // else P(X = 0) covers u: count 0
          ahead = 0;
        }
      }
      const unsigned need = __ballot_sync(FULL, !ahead);
      if (cursor < end) {
        const int s = cursor + __popc(need & below);
        cursor += __popc(need);
        if (!ahead && s < end) {
          next = entry[s];
          ahead = 1;
        }
      }
      if (!__any_sync(FULL, idx >= 0 || ahead)) break;
      const float p0 = p, cdf0 = cdf;
      const int j0 = j, alive0 = alive;
      int slow = 0;
      float2 t[DRAIN_TERMS];  // an alive lane takes terms j + 1, j + 2, ...
#pragma unroll
      for (int k = 0; k < DRAIN_TERMS; ++k) t[k] = term[j + 1 + k];
#pragma unroll
      for (int k = 0; k < DRAIN_TERMS; ++k) {
        const float x = __fmul_rn(p, r);
        const float q = div_fast(x, t[k].x, t[k].y);
        slow |= alive & !div_fast_exact(x);
        if (alive) {
          p = q;
          cdf = __fadd_rn(cdf, q);
          ++j;
          alive = u > cdf && j < INV_TERMS - 1;
        }
      }
      if (__any_sync(FULL, slow) && slow) {
        p = p0;
        cdf = cdf0;
        j = j0;
        alive = alive0;
        for (int k = 0; k < DRAIN_TERMS && alive; ++k) {
          const float2 t = term[j + 1];
          p = div_by_term(__fmul_rn(p, r), t.x, t.y);
          cdf = __fadd_rn(cdf, p);
          ++j;
          alive = u > cdf && j < INV_TERMS - 1;
        }
      }
    }
  }

  // 4. The tile's (min, max) to the image's words.
  for (int off = 16; off; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0) {
    red[warp] = lo;
    red[WARPS + warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      lo = fminf(lo, red[w]);
      hi = fmaxf(hi, red[WARPS + w]);
    }
    atomicMax(minmax + 2 * b, ~__float_as_uint(lo));
    atomicMax(minmax + 2 * b + 1, __float_as_uint(hi));
    // Release: the block's counts (ordered before by the barrier) and its
    // (min, max) show before the image's tally does.
    __threadfence();
    atomicAdd(minmax + 2 * (gridDim.x / tiles) + b, 1u);
  }
}

__device__ __forceinline__ float rescaled(float k, float lo, float span,
                                          float inv) {
  return span > 0.0f ? __fmul_rn(__fsub_rn(k, lo), inv) : 0.5f;
}

// In place on `out`: (count - min) / (max - min) per image, 0.5 where the
// image is constant. One block a RESCALE_TILE span of one image; it
// starts once its image's counting blocks have all finished (their tally
// in minmax[2 B + b]), so the spans of early images are rescaled while
// count_kernel's last blocks still run. The grid is launched when every
// counting block has started (griddepcontrol.launch_dependents), so the
// blocks it waits for hold their SMs already: the wait cannot starve them.
__global__ void __launch_bounds__(RESCALE_THREADS)
rescale_kernel(float* __restrict__ out, const unsigned* __restrict__ minmax,
               long long hw, int tiles) {
  const long long b = blockIdx.x / tiles;
  const long long e0 = static_cast<long long>(blockIdx.x % tiles) *
                       RESCALE_TILE;
  const int n = static_cast<int>(
      min(static_cast<long long>(RESCALE_TILE), hw - e0));
  float* o = out + b * hw + e0;
  if (threadIdx.x == 0) {
    const unsigned* tally = minmax + 2 * (gridDim.x / tiles) + b;
    const unsigned want = static_cast<unsigned>((hw + TILE - 1) / TILE);
    while (load_acquire(tally) < want) __nanosleep(256);
  }
  __syncthreads();
  // L2 reads (.cg): no line of `out` that this SM's L1 may hold from a
  // neighbouring span is trusted.
  const float lo = __uint_as_float(~__ldcg(minmax + 2 * b));
  const float hi = __uint_as_float(__ldcg(minmax + 2 * b + 1));
  const float span = __fsub_rn(hi, lo);
  const float inv = span > 0.0f ? __fdiv_rn(1.0f, span) : 0.0f;
  if (hw % 4 == 0) {  // every span starts on 16 bytes and holds n / 4 float4
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += RESCALE_THREADS) {
      float4 v = __ldcg(o4 + i);
      v.x = rescaled(v.x, lo, span, inv);
      v.y = rescaled(v.y, lo, span, inv);
      v.z = rescaled(v.z, lo, span, inv);
      v.w = rescaled(v.w, lo, span, inv);
      o4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += RESCALE_THREADS)
      o[i] = rescaled(__ldcg(o + i), lo, span, inv);
  }
}

// Every 32-bit pattern x against every j in [1, 31]: div_by_term against
// __fdiv_rn, bit for bit. Counts the mismatches and the fast-path uses.
__global__ void division_check_kernel(unsigned long long* __restrict__ tally) {
  unsigned long long bad = 0, fast = 0;
  for (unsigned long long t = blockIdx.x * static_cast<unsigned long long>(
                                  blockDim.x) + threadIdx.x;
       t < (1ull << 32); t += static_cast<unsigned long long>(gridDim.x) *
                              blockDim.x) {
    const float x = __uint_as_float(static_cast<uint32_t>(t));
    const float ax = fabsf(x);
    fast += ax >= 0x1p-100f && ax <= 0x1.fffffep127f;
    for (int j = 1; j < INV_TERMS; ++j) {
      const float fj = static_cast<float>(j);
      bad += __float_as_uint(div_by_term(x, fj, __frcp_rn(fj))) !=
             __float_as_uint(__fdiv_rn(x, fj));
    }
  }
  for (int off = 16; off; off >>= 1) {
    bad += __shfl_xor_sync(FULL, bad, off);
    fast += __shfl_xor_sync(FULL, fast, off);
  }
  if (threadIdx.x % 32 == 0) {
    atomicAdd(tally, bad);
    atomicAdd(tally + 1, fast);
  }
}

cudaError_t attributes(const void* fn, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  out[0] = static_cast<int>(a.sharedSizeBytes);
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, fn, threads,
                                                       0);
}

}  // namespace

// Of count_kernel (which = 0) or rescale_kernel (1) on the current device:
// out[0] static shared bytes, out[1] registers a thread, out[2] local
// (stack and spill) bytes a thread, out[3] blocks that fit on an SM.
extern "C" cudaError_t emx_degrade_attributes(int which, int* out) {
  if (out == nullptr || which < 0 || which > 1) return cudaErrorInvalidValue;
  return which == 0
             ? attributes(reinterpret_cast<const void*>(count_kernel),
                          THREADS, out)
             : attributes(reinterpret_cast<const void*>(rescale_kernel),
                          RESCALE_THREADS, out);
}

// imgs (B, H, W) f32, scales (B) f32, out (B, H, W) f32, minmax 3 x B
// uint32 scratch; seed one u64 on the device, the 64-bit Philox key;
// image_offset the batch's first image in the Philox counter (offset + B
// must stay below 2^32); all contiguous, on one device; hw = H * W,
// below 2^32.
// tiles = ceil(hw / 2048) and rescale_tiles = ceil(hw / 16384), the
// wrapper's plan (degrade_plan). phases: 1 the memset and count_kernel
// (the counts in `out`), 2 rescale_kernel (in place on `out`; it waits
// for the tallies of a phase 1 on the same buffers), 3 both. All on `stream` (CUDA 12.3+ stream capture takes the
// programmatic dependency into a graph); returns the first error.
extern "C" cudaError_t emx_poisson_degrade(const void* imgs, const void* scales,
                                           void* out, void* minmax, int B,
                                           long long hw, const void* seed,
                                           long long image_offset, int tiles,
                                           int rescale_tiles, int phases,
                                           cudaStream_t stream) {
  if (B <= 0 || hw <= 0 || hw > 0xFFFFFFFFLL || seed == nullptr ||
      image_offset < 0 ||
      image_offset + B > 0xFFFFFFFFLL || phases < 1 || phases > 3)
    return cudaErrorInvalidValue;
  if (tiles != (hw + TILE - 1) / TILE ||
      rescale_tiles != (hw + RESCALE_TILE - 1) / RESCALE_TILE)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * tiles > 0x7FFFFFFFLL)
    return cudaErrorInvalidConfiguration;
  float* o = static_cast<float*>(out);
  unsigned* mm = static_cast<unsigned*>(minmax);
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    err = cudaMemsetAsync(mm, 0, 3 * sizeof(unsigned) * B, stream);
    if (err != cudaSuccess) return err;
    count_kernel<<<B * tiles, THREADS, 0, stream>>>(
        static_cast<const float*>(imgs), static_cast<const float*>(scales), o,
        mm, hw, tiles, static_cast<const unsigned long long*>(seed),
        static_cast<unsigned>(image_offset));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(B) * rescale_tiles);
    cfg.blockDim = dim3(RESCALE_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const unsigned* cmm = mm;
    err = cudaLaunchKernelEx(&cfg, rescale_kernel, o, cmm, hw, rescale_tiles);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
  }
  return err;
}

// Exhaustive check of div_by_term (one launch, synchronous): tally[0]
// the (x, j) pairs that differ from __fdiv_rn, tally[1] the patterns x
// that take the multiply path. tally: two u64 on the device.
extern "C" cudaError_t emx_degrade_division_mismatches(void* tally) {
  if (tally == nullptr) return cudaErrorInvalidValue;
  unsigned long long* t = static_cast<unsigned long long*>(tally);
  cudaError_t err = cudaMemset(t, 0, 2 * sizeof(unsigned long long));
  if (err != cudaSuccess) return err;
  division_check_kernel<<<132 * 16, 256>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}
