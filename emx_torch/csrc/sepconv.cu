// Fused separable-conv block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel emx/ops/sepconv_kernel.py::fused_sepconv
// (body _sepconv_kernel). On NHWC bf16 activations, stride 1, rate 1, SAME
// zero padding, it computes with that kernel's roundings:
//
//   h   = bf16( sum over the 3x3 taps of f32(x) * dw, in f32, + dw_b )
//   out = bf16( clip( h @ bf16(pw) accumulated in f32 + pw_b, 0, 6 ) )
//
// h is bit-identical to the plain PyTorch version (sepconv_reference):
// the depthwise sum is taken tap by tap in (ky, kx) order, starting from
// +0, with separate round-to-nearest multiplies and adds (__fmul_rn,
// __fadd_rn: no FMA contraction), then + dw_b, then one round to bf16.
// Only the pointwise sum runs in another order (the tensor cores'), so
// the output may sit one bf16 step from the plain version's.
//
// What bounds it on this card: one pixel costs 2*C*Co + 18*C operations
// against 2*(C + Co) bytes of HBM traffic, 15 to 70 operations per byte
// at the flagship's shapes, far below the ~295 per byte at which the
// H100's bf16 tensor cores become the limit. So bytes set the least time:
// at B=8, 128x128, 0.0063, 0.0100, 0.0150, 0.0100, 0.0163 and 0.0201 ms
// for C -> Co = 16->64, 64->64, 128->64, 64->64, 80->128, 128->128 (x
// read once, out written once, at 3.35 TB/s). The kernel has to read x
// about once, keep h out of device memory, and keep the pointwise product
// (11.5 GFLOP over the six shapes) from setting the time.
//
// Design:
// * A persistent grid of blocks of 8 warps, sized by the host from the
//   occupancy query (1-2 blocks per SM). Each block walks work items: a
//   band of `band` consecutive output rows of one image, over a tile of
//   TP = 128 pixels along W. The host picks the band from B*H over the
//   number of blocks (B=8 at 128x128: 8 rows; B=1: 1 row).
// * Weights are staged once per block, not once per tile, while the
//   first window's copies are in flight: dw, dw_b and pw_b in f32, and
//   pw transposed to (Co, C) with K contiguous, rounded to bf16 (the
//   wrapper keeps its f32 weight API), zero-padded to K a multiple of 16
//   and N a multiple of 32. Ragged C (20, 80) thus adds zeros to the
//   product; ragged Co (24, 728) computes zeros that the masked store
//   drops.
// * A rolling window of three input rows (y-1, y, y+1) x (TP + 2) pixels
//   x all C channels sits in shared memory, filled with 16-byte cp.async
//   copies. Rows and columns outside the image, and channels past C, are
//   zero-filled by the copy (src-size 0): SAME padding is a bounds check,
//   never a padded copy. While row y computes, the copy of row y+2 into
//   the slot of row y-1 is in flight. (C not a multiple of 8, or x not
//   16-byte aligned: plain element loads into the same window.)
// * The depthwise pass reads the window, computes h once for all of Co
//   (each thread a run of pixels of four channels, sliding a 3 x 3
//   register window along the run, so each window value is read from
//   shared memory once per run), and writes it as bf16 into an A tile
//   of TP x (K + 8) values: the 16-byte row pad makes the row stride an
//   odd number of 16-byte units, so ldmatrix reads are free of bank
//   conflicts. The same pad is on the weight tile.
// * The pointwise product runs on the tensor cores with
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 and ldmatrix.x4 loads;
//   8 warps as 4 along pixels x 2 along outputs, each warp a 32 x NC/2
//   tile with f32 accumulators in registers (NC = 32, 64 or 128 outputs
//   per pass, a template parameter). mma.sync rather than wgmma: at
//   the full bf16 rate the product of the six shapes takes ~12 us of
//   their 78 us byte bound, so it does not set the time at a fraction of
//   that rate either, and mma.sync needs no descriptors or warpgroup
//   layout. Warps whose pixels lie
//   past W skip the product.
// * The epilogue adds pw_b, applies relu6 (NaN passes, as in the plain
//   version's clamp), stages the bf16 tile through shared memory and
//   stores it in 16-byte vectors; one row of a tile is one contiguous
//   run of TP * Co values when Co <= NC.
// * Shapes whose window does not fit the 227 KB of shared memory (the
//   728 -> 728 test shape) take a channel-chunked schedule in the same
//   kernel: for each output chunk, for each chunk of kc channels, the
//   three rows of that chunk are copied, h of that chunk is computed and
//   the product accumulates. It re-reads the window per chunk; it is
//   right, not fast, and off the main path.
// * Co > 128 takes several output passes over the same h tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TP = 128;        // pixels per tile along W
constexpr int THREADS = 256;   // 8 warps: 4 along pixels x 2 along outputs
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory per block, opted in

int n_tiles8(int co) { return co <= 32 ? 2 : (co <= 64 ? 4 : 8); }

// Byte offsets into dynamic shared memory; the wrapper's smem_bytes()
// repeats this sum. Every piece is a multiple of 16 bytes (kc % 16 == 0,
// nc % 32 == 0).
struct Layout {
  int win, hs, ws, os, dws, dwbs, pwbs, total;
};

__host__ __device__ inline Layout layout(int kc, int nc) {
  Layout l;
  l.win = 0;                                  // 3 x (TP + 2) x kc bf16
  l.hs = l.win + 3 * (TP + 2) * kc * 2;       // TP x (kc + 8) bf16
  l.ws = l.hs + TP * (kc + 8) * 2;            // nc x (kc + 8) bf16
  l.os = l.ws + nc * (kc + 8) * 2;            // TP x (nc + 8) bf16
  l.dws = l.os + TP * (nc + 8) * 2;           // 9 x kc f32
  l.dwbs = l.dws + 9 * kc * 4;                // kc f32
  l.pwbs = l.dwbs + kc * 4;                   // nc f32
  l.total = l.pwbs + nc * 4;
  return l;
}

struct Params {
  const __nv_bfloat16* x;
  const float* dw;
  const float* dwb;
  const float* pw;
  const float* pwb;
  __nv_bfloat16* out;
  int B, H, W, C, Co;
  int kc;      // channels per window pass (multiple of 16)
  int band;    // output rows per work item
  int tiles;   // pixel tiles along W
  int bands;   // bands per image
  long long items;
  int vec_in, vec_out;  // 16-byte paths usable for x / out
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int slot_of(int y) { return (y + 3) % 3; }

// Row y of image b into its window slot: window pixel j is image column
// x0 - 1 + j (j = 0 .. TP + 1), channels k0 .. k0 + kc - 1. Outside the
// image or past C: zeros.
__device__ __forceinline__ void load_row(const Params& p,
                                         __nv_bfloat16* win, int b, int y,
                                         int x0, int k0) {
  const int kc = p.kc;
  __nv_bfloat16* slot = win + slot_of(y) * (TP + 2) * kc;
  const bool row_in = y >= 0 && y < p.H;
  const size_t row = (static_cast<size_t>(b) * p.H + (row_in ? y : 0)) * p.W;
  if (p.vec_in) {
    const int vecs = kc / 8;
    for (int e = threadIdx.x; e < (TP + 2) * vecs; e += THREADS) {
      const int j = e / vecs, v = e - j * vecs;
      const int xx = x0 - 1 + j, c = k0 + v * 8;
      const bool in = row_in && xx >= 0 && xx < p.W && c < p.C;
      const __nv_bfloat16* src =
          in ? p.x + (row + xx) * p.C + c : p.x;  // not read when !in
      cp_async16(smem_u32(slot + j * kc + v * 8), src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < (TP + 2) * kc; e += THREADS) {
      const int j = e / kc, cc = e - j * kc;
      const int xx = x0 - 1 + j, c = k0 + cc;
      __nv_bfloat16 v = __ushort_as_bfloat16(0);
      if (row_in && xx >= 0 && xx < p.W && c < p.C)
        v = p.x[(row + xx) * p.C + c];
      slot[j * kc + cc] = v;
    }
  }
}

// dw and dw_b of channels k0 .. k0 + kc - 1, zero past C.
__device__ __forceinline__ void stage_dw(const Params& p, float* dws,
                                         float* dwbs, int k0) {
  const int kc = p.kc;
  for (int e = threadIdx.x; e < 9 * kc; e += THREADS) {
    const int t = e / kc, c = k0 + e - t * kc;
    dws[e] = c < p.C ? p.dw[t * p.C + c] : 0.f;
  }
  for (int e = threadIdx.x; e < kc; e += THREADS)
    dwbs[e] = k0 + e < p.C ? p.dwb[k0 + e] : 0.f;
}

// pw (C, Co) f32 -> ws (nc, kc + 8) bf16, transposed and rounded, for
// outputs n0 .. n0 + nc - 1 and channels k0 .. k0 + kc - 1; pw_b too.
// STAGE_LOADS loads are issued before their stores, so that a thread
// waits on L2 a few times, not once per weight.
constexpr int STAGE_LOADS = 16;

__device__ __forceinline__ void stage_pw(const Params& p,
                                         __nv_bfloat16* ws, float* pwbs,
                                         int nc, int n0, int k0) {
  const int kc = p.kc, total = nc * kc;
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * STAGE_LOADS) {
    float w[STAGE_LOADS];
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int k = e / nc, n = e - k * nc;  // lanes walk Co: coalesced
      w[u] = e < total && n0 + n < p.Co && k0 + k < p.C
                 ? __ldg(p.pw + static_cast<size_t>(k0 + k) * p.Co + n0 + n)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int k = e / nc, n = e - k * nc;
      if (e < total) ws[n * (kc + 8) + k] = __float2bfloat16_rn(w[u]);
    }
  }
  for (int e = threadIdx.x; e < nc; e += THREADS)
    pwbs[e] = n0 + e < p.Co ? p.pwb[n0 + e] : 0.f;
}

// Four bf16 window values (8 bytes) widened to f32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// h of output row y from the window rows y-1, y, y+1, in the plain
// version's tap order and roundings. A thread takes runs of `run`
// consecutive pixels of one quad of channels: it holds the quad's nine
// taps in registers and slides a 3 x 3 window of window values (as f32)
// along the run, so that each value is read from shared memory and
// widened once per run instead of three times, and the taps once per run
// instead of once per pixel. Lanes walk the quads of one pixel, so a
// warp's loads are contiguous.
__device__ __forceinline__ void depthwise(const Params& p,
                                          const __nv_bfloat16* win,
                                          const float* dws, const float* dwbs,
                                          __nv_bfloat16* hs, int y) {
  const int kc = p.kc, quads = kc / 4;
  int run = 1;  // the largest power of two <= kc / 8: ~THREADS units
  while (run * 2 <= kc / 8 && run * 2 <= TP) run *= 2;
  const __nv_bfloat16* rows[3];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
    rows[ky] = win + slot_of(y - 1 + ky) * (TP + 2) * kc;
  for (int u = threadIdx.x; u < quads * (TP / run); u += THREADS) {
    const int q = u % quads, c = q * 4, px0 = (u / quads) * run;
    float4 w[9];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      w[t] = *reinterpret_cast<const float4*>(dws + t * kc + c);
    const float4 bias = *reinterpret_cast<const float4*>(dwbs + c);
    float4 col[3][3];  // [kx][ky]: window pixels px, px + 1, px + 2
#pragma unroll
    for (int kx = 0; kx < 2; ++kx)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        col[kx][ky] = load4(rows[ky] + (px0 + kx) * kc + c);
    for (int px = px0; px < px0 + run; ++px) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        col[2][ky] = load4(rows[ky] + (px + 2) * kc + c);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 v = col[kx][ky], t = w[ky * 3 + kx];
          s0 = __fadd_rn(s0, __fmul_rn(v.x, t.x));
          s1 = __fadd_rn(s1, __fmul_rn(v.y, t.y));
          s2 = __fadd_rn(s2, __fmul_rn(v.z, t.z));
          s3 = __fadd_rn(s3, __fmul_rn(v.w, t.w));
        }
      }
      const __nv_bfloat162 h[2] = {
          __floats2bfloat162_rn(__fadd_rn(s0, bias.x), __fadd_rn(s1, bias.y)),
          __floats2bfloat162_rn(__fadd_rn(s2, bias.z),
                                __fadd_rn(s3, bias.w))};
      *reinterpret_cast<uint2*>(hs + px * (kc + 8) + c) =
          *reinterpret_cast<const uint2*>(h);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        col[0][ky] = col[1][ky];
        col[1][ky] = col[2][ky];
      }
    }
  }
}

// acc += h (TP x kc) @ ws^T (kc x nc) on this warp's 32 x nc/2 tile.
template <int NT8>
__device__ __forceinline__ void pointwise(const __nv_bfloat16* hs,
                                          const __nv_bfloat16* ws, int kc,
                                          float (&acc)[2][NT8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * NT8 * 8;
  const int stride = kc + 8;
  // ldmatrix.x4 row addresses: A as (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // B as (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
  const uint32_t a_addr =
      smem_u32(hs + (m0 + (lane & 15)) * stride + (lane >> 4) * 8);
  const uint32_t b_addr =
      smem_u32(ws + (n0 + (lane & 7) + (lane >> 4) * 8) * stride +
               ((lane >> 3) & 1) * 8);
  for (int kk = 0; kk < kc; kk += 16) {
    uint32_t a[2][4];
    ldmatrix_x4(a[0], a_addr + kk * 2);
    ldmatrix_x4(a[1], a_addr + (16 * stride + kk) * 2);
#pragma unroll
    for (int np = 0; np < NT8 / 2; ++np) {
      uint32_t bq[4];
      ldmatrix_x4(bq, b_addr + (np * 16 * stride + kk) * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], bq[0], bq[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
      }
    }
  }
}

// + pw_b, relu6, bf16, into the output tile os (TP x (nc + 8)).
template <int NT8>
__device__ __forceinline__ void epilogue(const float (&acc)[2][NT8][4],
                                         const float* pwbs,
                                         __nv_bfloat16* os) {
  constexpr int NC = 16 * NT8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * NT8 * 8;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int n = n0 + nt * 8 + q * 2;
      const float b0 = pwbs[n], b1 = pwbs[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = acc[mt][nt][2 * half] + b0;
        float v1 = acc[mt][nt][2 * half + 1] + b1;
        v0 = v0 < 0.f ? 0.f : (v0 > 6.f ? 6.f : v0);  // relu6; NaN passes
        v1 = v1 < 0.f ? 0.f : (v1 > 6.f ? 6.f : v1);
        const int r = m0 + mt * 16 + g + half * 8;
        *reinterpret_cast<__nv_bfloat162*>(os + r * (NC + 8) + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The staged tile of output row y, pixels x0.., outputs n0.., to out.
__device__ __forceinline__ void store_tile(const Params& p,
                                           const __nv_bfloat16* os, int nc,
                                           int b, int y, int x0, int n0) {
  const int npx = min(TP, p.W - x0), ncv = min(nc, p.Co - n0);
  const size_t base = (static_cast<size_t>(b) * p.H + y) * p.W + x0;
  if (p.vec_out) {  // Co % 8 == 0, so ncv % 8 == 0
    const int vecs = ncv / 8;
    for (int e = threadIdx.x; e < npx * vecs; e += THREADS) {
      const int px = e / vecs, v = e - px * vecs;
      *reinterpret_cast<uint4*>(p.out + (base + px) * p.Co + n0 + v * 8) =
          *reinterpret_cast<const uint4*>(os + px * (nc + 8) + v * 8);
    }
  } else {
    for (int e = threadIdx.x; e < npx * ncv; e += THREADS) {
      const int px = e / ncv, n = e - px * ncv;
      p.out[(base + px) * p.Co + n0 + n] = os[px * (nc + 8) + n];
    }
  }
}

template <int NT8>
__global__ void __launch_bounds__(THREADS, NT8 == 8 ? 1 : 2)
sepconv_kernel(const Params p) {
  constexpr int NC = 16 * NT8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(p.kc, NC);
  auto* win = reinterpret_cast<__nv_bfloat16*>(smem + L.win);
  auto* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.hs);
  auto* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  auto* os = reinterpret_cast<__nv_bfloat16*>(smem + L.os);
  auto* dws = reinterpret_cast<float*>(smem + L.dws);
  auto* dwbs = reinterpret_cast<float*>(smem + L.dwbs);
  auto* pwbs = reinterpret_cast<float*>(smem + L.pwbs);

  const int nk = (p.C + p.kc - 1) / p.kc;  // channel passes
  const int nn = (p.Co + NC - 1) / NC;     // output passes
  const int warp = threadIdx.x >> 5;
  int staged_dw = -1, staged_pw = -1;  // which chunk each tile holds
  float acc[2][NT8][4];

  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int tile = static_cast<int>(item % p.tiles);
    const long long rest = item / p.tiles;
    const int band = static_cast<int>(rest % p.bands);
    const int b = static_cast<int>(rest / p.bands);
    const int x0 = tile * TP, y0 = band * p.band;
    const int y1 = min(y0 + p.band, p.H);
    const bool active = (warp & 3) * 32 < p.W - x0;  // pixels in the image

    if (nk == 1) {
      // The whole window fits: it rolls down the band.
      __syncthreads();  // the previous item is done with every tile
      for (int r = -1; r <= 1; ++r) load_row(p, win, b, y0 + r, x0, 0);
      cp_async_commit();
      // Weights are staged while the window's copies are in flight.
      if (staged_dw != 0) {
        stage_dw(p, dws, dwbs, 0);
        staged_dw = 0;
      }
      if (nn == 1 && staged_pw != 0) {
        stage_pw(p, ws, pwbs, NC, 0, 0);
        staged_pw = 0;
      }
      cp_async_wait_all();
      __syncthreads();
      for (int y = y0; y < y1; ++y) {
        depthwise(p, win, dws, dwbs, hs, y);
        __syncthreads();  // h complete; row y-1's slot is free
        if (y + 1 < y1) {
          load_row(p, win, b, y + 2, x0, 0);  // lands while y computes
          cp_async_commit();
        }
        for (int n = 0; n < nn; ++n) {
          if (staged_pw != n) {
            stage_pw(p, ws, pwbs, NC, n * NC, 0);
            staged_pw = n;
            __syncthreads();
          }
          if (active) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
            pointwise<NT8>(hs, ws, p.kc, acc);
            epilogue<NT8>(acc, pwbs, os);
          }
          __syncthreads();
          store_tile(p, os, NC, b, y, x0, n * NC);
          __syncthreads();
        }
        cp_async_wait_all();
        __syncthreads();
      }
    } else {
      // Channel-chunked: the window of each chunk is copied anew.
      for (int y = y0; y < y1; ++y) {
        for (int n = 0; n < nn; ++n) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
          for (int k = 0; k < nk; ++k) {
            for (int r = -1; r <= 1; ++r)
              load_row(p, win, b, y + r, x0, k * p.kc);
            cp_async_commit();
            if (staged_dw != k) {
              stage_dw(p, dws, dwbs, k * p.kc);
              staged_dw = k;
            }
            if (staged_pw != n * nk + k) {
              stage_pw(p, ws, pwbs, NC, n * NC, k * p.kc);
              staged_pw = n * nk + k;
            }
            cp_async_wait_all();
            __syncthreads();
            depthwise(p, win, dws, dwbs, hs, y);
            __syncthreads();
            if (active) pointwise<NT8>(hs, ws, p.kc, acc);
            __syncthreads();  // window, h and weights free for the next chunk
          }
          if (active) epilogue<NT8>(acc, pwbs, os);
          __syncthreads();
          store_tile(p, os, NC, b, y, x0, n * NC);
          __syncthreads();
        }
      }
    }
  }
}

template <int NT8>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sepconv_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sepconv_kernel<NT8><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NT8>
cudaError_t occupancy(int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      sepconv_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sepconv_kernel<NT8>, THREADS, smem);
}

}  // namespace

// Blocks of the kernel for `co` outputs that fit on one SM with `smem`
// bytes of dynamic shared memory, on the current device.
extern "C" cudaError_t emx_sepconv_occupancy(int co, int smem, int* blocks) {
  if (co <= 0 || smem <= 0 || smem > SMEM_LIMIT || blocks == nullptr)
    return cudaErrorInvalidValue;
  switch (n_tiles8(co)) {
    case 2: return occupancy<2>(smem, blocks);
    case 4: return occupancy<4>(smem, blocks);
    default: return occupancy<8>(smem, blocks);
  }
}

// x (B, H, W, C) bf16; dw (3, 3, C) f32; dw_b (C) f32; pw (C, Co) f32;
// pw_b (Co) f32; out (B, H, W, Co) bf16. All contiguous, on one device.
// kc, band, grid and smem are the wrapper's plan (sepconv_plan); smem
// must equal this source's layout for (kc, Co). Launches on `stream` and
// returns cudaGetLastError().
extern "C" cudaError_t emx_sepconv_bf16(const void* x, const void* dw,
                                        const void* dw_b, const void* pw,
                                        const void* pw_b, void* out, int B,
                                        int H, int W, int C, int Co, int kc,
                                        int band, int grid, int smem,
                                        cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || band <= 0 ||
      grid <= 0 || kc < 16 || kc % 16 || kc > (C + 15) / 16 * 16)
    return cudaErrorInvalidValue;
  const int nt8 = n_tiles8(Co);
  if (smem != layout(kc, 16 * nt8).total || smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dw = static_cast<const float*>(dw);
  p.dwb = static_cast<const float*>(dw_b);
  p.pw = static_cast<const float*>(pw);
  p.pwb = static_cast<const float*>(pw_b);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Co = Co;
  p.kc = kc;
  p.band = band;
  p.tiles = (W + TP - 1) / TP;
  p.bands = (H + band - 1) / band;
  p.items = static_cast<long long>(B) * p.bands * p.tiles;
  p.vec_in = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_out = Co % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (nt8) {
    case 2: return launch<2>(p, grid, smem, stream);
    case 4: return launch<4>(p, grid, smem, stream);
    default: return launch<8>(p, grid, smem, stream);
  }
}
