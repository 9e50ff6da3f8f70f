// flash_attention_hd256: forward attention of the LM zoo for head dims
// 128 < hd <= 256 (recurrentgemma-9b's local attention, hd 256), bf16 on
// the tensor cores (mma.sync) and f32 on the CUDA cores (FMA).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _attn_kernel) for the head dims that the
// hd <= 128 routes (flash_attention_sm90.cu, flash_attention_tf32.cu)
// do not take, in the model layout [B, S, H, hd] read through strides.
// For batch b, query head h (kv head h / (H / KH)) and query row i at
// position q_pos = q_offset + i:
//
//     s[k]  = (f32(q[b,i,h,:]) . f32(k[b,k,kh,:])) * scale   (bf16)
//     s[k]  = (f32(q[b,i,h,:]) * scale) . f32(k[b,k,kh,:])   (f32)
//     s[k]  = -1e30 where k >= Sk, (causal) k > q_pos,
//             or (window) q_pos - k >= window
//     out   = sum_k exp(s[k] - m) v[b,k,kh,:] / max(sum_k exp(s[k] - m),
//             1e-30), carried as a running (max m, normalizer l, O) over
//             key tiles, stored in q's dtype
//
// Key tiles wholly outside the causal window are skipped: at
// recurrentgemma-9b's layer (S = 8192, window 2048) a block walks 33 of
// up to 128 tiles. That is exact for every query row that sees a key;
// the wrapper refuses inputs with a row that sees none.
//
// What bounds it on an H100: at that layer (B = 2, S = 8192, H = 16,
// KH = 1, hd = 256, causal, window 2048) the unmasked (q, k) pairs are
// 469.8 M per head pair, 4 hd FLOPs each: 4.81e11 FLOPs, 0.486 ms at
// the bf16 tensor-core peak (989 TFLOP/s) and 7.18 ms at the fp32 CUDA
// cores' 67 TFLOP/s; q, k, v and out move 0.14 GB (bf16), 0.04 ms. So
// the operations bound both routes.
//
// Why a route of its own. The hd <= 128 bf16 kernel keeps 128 query rows
// and two stages of 128 keys in shared memory; at hd 256 that plan needs
// 256 KB, more than a block's 227 KB, and a 64 x 256 f32 O is 128
// registers a thread per warpgroup. This kernel is the simple plan that
// is right; it issues more work than the bound counts (below).
//
// bf16 (flash_hd256_bf16): a block of 4 warps takes 64 query rows (16 a
// warp) and one slab of 128 of the 256 output columns (grid.z = batch x
// 2 slabs), so O is 16 x 128 f32 a warp, 64 registers a thread. Each
// slab computes S = Q·K^T over the whole head dim again: Q·K^T runs
// twice, 1.5x the bound's products with P·V's two halves below. Per key
// tile of 64: S = Q·K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate),
// each product of two bf16 exact in f32, its fragments read by ldmatrix;
// the online softmax in f32 on the S accumulator's registers, masked only
// in tiles that some row of the block does not see whole; P, rounded once
// to bf16, fails the element-wise check (the hd <= 128 kernel found ~50x
// its limit), so P = p_hi + p_lo, two bf16 halves, and P·V takes both,
// V's fragments by ldmatrix.trans. The tensor cores' f32 accumulator
// rounds toward zero at each k16 step, which carried across a 2048-key
// row fails the check at near-zero outputs (as the hd <= 128 kernel once
// did): each key tile's P·V, four 8-column n-tiles at a time (four
// independent accumulator chains), goes into a fresh accumulator, folded
// into O as O·alpha + P·V with f32 FMAs on the CUDA cores. Q, K and the
// slab of V come in by cp.async (16 bytes a copy, zeros past Sk and hd):
// the next tile's K while this tile's softmax and P·V run, its V while
// the next S runs. 171 registers, no spills (ptxas, -Xptxas -v).
//
// f32 (flash_hd256_f32): a block of 8 warps takes 64 query rows (8 a
// warp) and all 256 columns; per key tile of 32, warp w computes the
// scores of its 8 rows against the tile's keys (a key a lane) by FMAs
// over the head dim, its online softmax by warp shuffles, then
// O[8 rows][8 columns a lane] += P·V. q is scaled in f32 after the cast
// and before the product, as the TPU kernel scales it; every product
// and sum is f32, so only the order of the sums differs from the plain
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHdMax = 256;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

struct Shape {
  int B, Sq, Sk, H, KH, hd, causal, window, q_offset;
  float scale;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
};

// the key tiles [lo, hi] that query rows [r0, r1] may see
__device__ __forceinline__ void key_tiles(const Shape& sh, int r0, int r1,
                                          int tile, int& lo, int& hi) {
  const int p0 = sh.q_offset + r0, p1 = sh.q_offset + r1;
  const int k_hi = sh.causal ? min(sh.Sk - 1, p1) : sh.Sk - 1;
  const int k_lo = sh.window > 0 ? max(0, p0 - sh.window + 1) : 0;
  lo = k_lo / tile;
  hi = k_hi / tile;
}

__device__ __forceinline__ bool visible(const Shape& sh, int pos, int key) {
  return key < sh.Sk && (!sh.causal || key <= pos) &&
         (sh.window <= 0 || pos - key < sh.window);
}

// ------------------------------------------------------------------ bf16
constexpr int kBQ = 64;                  // query rows a block, 16 a warp
constexpr int kBK = 64;                  // keys a tile
constexpr int kSlab = 128;               // output columns a block
constexpr int kSlabs = kHdMax / kSlab;
constexpr int kQKStride = kHdMax + 8;    // bf16 a row of Qs, Ks (no bank
constexpr int kVStride = kSlab + 8;      // conflicts on fragment loads)
constexpr int kThreads = 128;
constexpr int kSmemBf16 =
    (kBQ * kQKStride + kBK * kQKStride + kBK * kVStride) * 2;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 halves: hi = rn(x, y), lo = rn((x, y) - hi)
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// d += a (16 x 16, row) · b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x 8-element chunks of a [rows, hd] tile into shared memory by
// cp.async (16 bytes a copy), zeros past `valid_rows` and past hd; the
// caller commits the group
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int stride,
                                           const __nv_bfloat16* src,
                                           int64_t src_stride, int rows,
                                           int valid_rows, int col0,
                                           int cols, int hd) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool ok = r < valid_rows && col0 + c < hd;
    const __nv_bfloat16* from = ok ? src + r * src_stride + col0 + c : src;
    const unsigned to =
        (unsigned)__cvta_generic_to_shared(dst + r * stride + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for all but the newest committed group, then for every thread
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
}

// four 8 x 8 b16 matrices from shared memory, row addresses from lanes
// 8i..8i+7 for matrix i (transposed with `trans`)
template <bool trans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4],
                                      const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
}

__global__ void __launch_bounds__(kThreads)
    flash_hd256_bf16(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, const Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * kQKStride;
  __nv_bfloat16* Vs = Ks + kBK * kQKStride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y;
  const int b = blockIdx.z / kSlabs, slab = blockIdx.z % kSlabs;
  const int col0 = slab * kSlab;
  if (col0 >= sh.hd) return;
  const int kh = h / (sh.H / sh.KH);
  const __nv_bfloat16* kb = k + b * sh.ksb + kh * sh.ksh;
  const __nv_bfloat16* vb = v + b * sh.vsb + kh * sh.vsh;
  const int q_last = min(q0 + kBQ, sh.Sq) - 1;
  int t_lo, t_hi;
  key_tiles(sh, q0, q_last, kBK, t_lo, t_hi);
  // groups in flight: Q with K(t_lo), then V(t_lo); then per tile K(t+1)
  // after S, V(t+1) after P·V, each waited for one group later
  stage_bf16(Qs, kQKStride, q + b * sh.qsb + h * sh.qsh + q0 * sh.qss,
             sh.qss, kBQ, sh.Sq - q0, 0, kHdMax, sh.hd);
  stage_bf16(Ks, kQKStride, kb + t_lo * kBK * sh.kss, sh.kss, kBK,
             sh.Sk - t_lo * kBK, 0, kHdMax, sh.hd);
  commit();
  stage_bf16(Vs, kVStride, vb + t_lo * kBK * sh.vss, sh.vss, kBK,
             sh.Sk - t_lo * kBK, col0, kSlab, sh.hd);
  commit();

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int pos0 = sh.q_offset + row0, pos1 = pos0 + 8;
  const int k_steps = (sh.hd + 15) / 16;
  float o[kSlab / 8][4];
#pragma unroll
  for (int j = 0; j < kSlab / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // ldmatrix row addresses: Q's A fragment (rows 0-7 / 8-15, k 0-7 /
  // 8-15), K's B fragments of two n-tiles (keys, k halves), V's
  // transposed B fragments of two n-tiles (keys 0-7 / 8-15, columns)
  const __nv_bfloat16* qa =
      Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kQKStride +
      (lane >> 4) * 8;
  const __nv_bfloat16* ka =
      Ks + ((lane >> 4) * 8 + (lane & 7)) * kQKStride + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* va =
      Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * kVStride + (lane >> 4) * 8;

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int k0 = kt * kBK;
    wait_all_but_newest();                   // Q and K(kt) are in

    // S = Q·K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < k_steps; ++kk) {
      uint32_t af[4];
      ldsm4<false>(af, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        uint32_t bf[4];
        ldsm4<false>(bf, ka + j * 8 * kQKStride + kk * 16);
        mma_bf16(s[j], af, bf[0], bf[1]);
        mma_bf16(s[j + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();                         // every warp is done with Ks
    if (kt < t_hi)
      stage_bf16(Ks, kQKStride, kb + (k0 + kBK) * sh.kss, sh.kss, kBK,
                 sh.Sk - k0 - kBK, 0, kHdMax, sh.hd);
    commit();

    // online softmax over the tile; c0,c1 are row g, c2,c3 row g + 8.
    // A tile that every row of the block sees whole takes no mask.
    const bool whole = k0 + kBK <= sh.Sk &&
                       (!sh.causal || k0 + kBK - 1 <= sh.q_offset + q0) &&
                       (sh.window <= 0 ||
                        sh.q_offset + q_last - k0 < sh.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = whole || visible(sh, e < 2 ? pos0 : pos1, key);
        const float x = ok ? s[j][e] * sh.scale : kNegInf;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - (e < 2 ? m0 : m1));
        s[j][e] = p;
        if (e < 2) rs0 += p; else rs1 += p;
      }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, d);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, d);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;

    // P as A fragments of four k16 steps, in bf16 halves
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    wait_all_but_newest();                   // V(kt) is in
    // O = O·alpha + P·V, four n-tiles of 8 columns at a time, each from a
    // fresh accumulator
#pragma unroll
    for (int n4 = 0; n4 < kSlab / 8; n4 += 4) {
      float acc[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t b01[4], b23[4];
        ldsm4<true>(b01, va + kk * 16 * kVStride + n4 * 8);
        ldsm4<true>(b23, va + kk * 16 * kVStride + (n4 + 2) * 8);
        mma_bf16(acc[0], pl[kk], b01[0], b01[1]);
        mma_bf16(acc[1], pl[kk], b01[2], b01[3]);
        mma_bf16(acc[2], pl[kk], b23[0], b23[1]);
        mma_bf16(acc[3], pl[kk], b23[2], b23[3]);
        mma_bf16(acc[0], ph[kk], b01[0], b01[1]);
        mma_bf16(acc[1], ph[kk], b01[2], b01[3]);
        mma_bf16(acc[2], ph[kk], b23[0], b23[1]);
        mma_bf16(acc[3], ph[kk], b23[2], b23[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[n4 + i][0] = fmaf(o[n4 + i][0], al0, acc[i][0]);
        o[n4 + i][1] = fmaf(o[n4 + i][1], al0, acc[i][1]);
        o[n4 + i][2] = fmaf(o[n4 + i][2], al1, acc[i][2]);
        o[n4 + i][3] = fmaf(o[n4 + i][3], al1, acc[i][3]);
      }
    }
    __syncthreads();                         // every warp is done with Vs
    if (kt < t_hi)
      stage_bf16(Vs, kVStride, vb + (k0 + kBK) * sh.vss, sh.vss, kBK,
                 sh.Sk - k0 - kBK, col0, kSlab, sh.hd);
    commit();
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + b * sh.osb + h * sh.osh;
#pragma unroll
  for (int nt = 0; nt < kSlab / 8; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    if (col >= sh.hd) continue;
    if (row0 < sh.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * sh.oss + col) =
          __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
    if (row1 < sh.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * sh.oss + col) =
          __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
  }
}

// ------------------------------------------------------------------- f32
constexpr int kFBQ = 64;                 // query rows a block, 8 a warp
constexpr int kFBK = 32;                 // keys a tile, one a lane
constexpr int kFThreads = 256;
constexpr int kFQStride = kHdMax + 4;    // float4 rows
constexpr int kFKStride = kHdMax + 1;    // a lane a row: no bank conflict
constexpr int kFPStride = kFBQ + 4;      // P^T: [key][row]
constexpr int kSmemF32 =
    (kFBQ * kFQStride + kFBK * kFKStride + kFBK * kHdMax + kFBK * kFPStride) *
    4;

// a [rows, hd] f32 tile into shared memory (times `mul`), zero past
// `valid_rows` and past hd
__device__ __forceinline__ void stage_f32(float* dst, int stride,
                                          const float* src, int64_t src_stride,
                                          int rows, int valid_rows, int hd,
                                          float mul) {
  for (int i = threadIdx.x; i < rows * kHdMax; i += blockDim.x) {
    const int r = i / kHdMax, c = i % kHdMax;
    dst[r * stride + c] =
        r < valid_rows && c < hd ? src[r * src_stride + c] * mul : 0.f;
  }
}

__global__ void __launch_bounds__(kFThreads)
    flash_hd256_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    const Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kFBQ * kFQStride;
  float* Vs = Ks + kFBK * kFKStride;
  float* Ps = Vs + kFBK * kHdMax;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kFBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (sh.H / sh.KH);
  const float* kb = k + b * sh.ksb + kh * sh.ksh;
  const float* vb = v + b * sh.vsb + kh * sh.vsh;
  stage_f32(Qs, kFQStride, q + b * sh.qsb + h * sh.qsh + q0 * sh.qss, sh.qss,
            kFBQ, sh.Sq - q0, sh.hd, sh.scale);

  const int r0 = warp * 8;                    // the warp's first row
  const int hd4 = (sh.hd + 3) / 4;
  int t_lo, t_hi;
  key_tiles(sh, q0, min(q0 + kFBQ, sh.Sq) - 1, kFBK, t_lo, t_hi);
  float o[8][8], m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[r][j] = 0.f;
  }

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int k0 = kt * kFBK;
    __syncthreads();
    stage_f32(Ks, kFKStride, kb + k0 * sh.kss, sh.kss, kFBK, sh.Sk - k0,
              sh.hd, 1.f);
    stage_f32(Vs, kHdMax, vb + k0 * sh.vss, sh.vss, kFBK, sh.Sk - k0, sh.hd,
              1.f);
    __syncthreads();

    // scores of the warp's 8 rows against key `lane`
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float* kr = Ks + lane * kFKStride;
    for (int d4 = 0; d4 < hd4; ++d4) {
      const float k_0 = kr[4 * d4], k_1 = kr[4 * d4 + 1],
                  k_2 = kr[4 * d4 + 2], k_3 = kr[4 * d4 + 3];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (r0 + r) * kFQStride +
                                             4 * d4);
        s[r] = fmaf(qv.x, k_0, s[r]);
        s[r] = fmaf(qv.y, k_1, s[r]);
        s[r] = fmaf(qv.z, k_2, s[r]);
        s[r] = fmaf(qv.w, k_3, s[r]);
      }
    }
    float alpha[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int pos = sh.q_offset + q0 + r0 + r;
      const float x = visible(sh, pos, k0 + lane) ? s[r] : kNegInf;
      float mx = x;
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      mx = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - mx);
      m[r] = mx;
      const float p = expf(x - mx);
      float rs = p;
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, d);
      l[r] = l[r] * alpha[r] + rs;
      Ps[lane * kFPStride + r0 + r] = p;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[r][j] *= alpha[r];
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 pa =
          *reinterpret_cast<const float4*>(Ps + kk * kFPStride + r0);
      const float4 pb =
          *reinterpret_cast<const float4*>(Ps + kk * kFPStride + r0 + 4);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float* vr = Vs + kk * kHdMax + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float vv = vr[32 * j];
#pragma unroll
        for (int r = 0; r < 8; ++r) o[r][j] = fmaf(p[r], vv, o[r][j]);
      }
    }
    __syncwarp();                 // Ps is rewritten by the next tile
  }

  float* ob = out + b * sh.osb + h * sh.osh;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sh.Sq) continue;
    const float d = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = lane + 32 * j;
      if (col < sh.hd) ob[row * sh.oss + col] = o[r][j] / d;
    }
  }
}

int current_slot() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices ? dev : -1;
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, T*, const Shape),
           bool* configured, int smem, dim3 grid, int threads, const void* q,
           const void* k, const void* v, void* out, const Shape& sh,
           void* stream) {
  const int slot = current_slot();
  if (slot < 0 || !configured[slot]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (slot >= 0) configured[slot] = true;
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sh);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Sq,H,hd], k/v [B,Sk,KH,hd], out [B,Sq,H,hd] on the device, each
// given by its batch, sequence and head strides in elements (the
// head-dim axis contiguous), 128 < hd <= 256 and hd a multiple of 8; for
// bf16, 16-byte aligned base pointers and strides that are multiples of
// 8 elements. window 0 = none. Launches on `stream`; returns
// cudaGetLastError().
#define FLASH_HD256_ARGS                                                      \
  const void *q, const void *k, const void *v, void *out, int B, int Sq,      \
      int Sk, int H, int KH, int hd, int64_t qsb, int64_t qss, int64_t qsh,   \
      int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,        \
      int64_t vsh, int64_t osb, int64_t oss, int64_t osh, int causal,         \
      int window, int q_offset, float scale, void *stream
#define FLASH_HD256_SHAPE                                                     \
  const Shape sh{B,   Sq,  Sk,  H,   KH,  hd,  causal, window, q_offset,     \
                 scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,    vsh,       \
                 osb, oss, osh}

extern "C" int flash_attention_hd256_bf16(FLASH_HD256_ARGS) {
  static bool configured[kMaxDevices] = {};
  FLASH_HD256_SHAPE;
  return launch<__nv_bfloat16>(
      flash_hd256_bf16, configured, kSmemBf16,
      dim3((Sq + kBQ - 1) / kBQ, H, B * kSlabs), kThreads, q, k, v, out, sh,
      stream);
}

extern "C" int flash_attention_hd256_f32(FLASH_HD256_ARGS) {
  static bool configured[kMaxDevices] = {};
  FLASH_HD256_SHAPE;
  return launch<float>(flash_hd256_f32, configured, kSmemF32,
                       dim3((Sq + kFBQ - 1) / kFBQ, H, B), kFThreads, q, k,
                       v, out, sh, stream);
}
