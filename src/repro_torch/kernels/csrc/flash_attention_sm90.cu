// flash_attention_sm90: the bf16 forward attention of the LM zoo on
// Hopper's tensor cores (wgmma), with its tiles brought in by TMA.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _attn_kernel) for bf16 inputs, in the model
// layout [B, S, H, hd] read through strides. For batch b, query head h
// (kv head h / (H / KH)) and query row i at position q_pos = q_offset + i:
//
//     s[k]  = (q[b,i,h,:] . k[b,k,kh,:]) * scale            (f32)
//     s[k]  = -1e30 where k >= Sk, (causal) k > q_pos,
//             or (window) q_pos - k >= window
//     out   = sum_k exp(s[k] - m) v[b,k,kh,:] / max(sum_k exp(s[k] - m),
//             1e-30), carried as a running (max m, normalizer l, O) over
//             key tiles, stored in bf16 (round to nearest even)
//
// The TPU kernel casts q, k, v to f32 and scales q before the product.
// Here q . k is a bf16 x bf16 product with f32 sums: each product is
// exact in f32, and the scale is applied to the f32 score after it,
// which moves nothing that the f32 reference check can see.
//
// Why P is split. The usual flash kernel rounds P to bf16 for P.V. Held
// element by element against the f32 arithmetic (|out - ref| <=
// 2^-6 |ref| + 1e-5 in bf16), that fails. The emulation of both
// roundings in tests/test_torch_zoo_kernels.py (`_bf16_worst`), on
// random bf16 inputs at B=1, S=2048, H=4, hd=120, causal, window 1024:
//
//     P.V as                              worst |d| / limit   over it
//     bf16(p) . V                                66.0            5.3 %
//     bf16(p) . V + bf16(p - bf16(p)) . V         0.494          0
//
// With the split P carries 16 bits into the product, and the output's
// one bf16 rounding (at most half the limit) is what is left.
//
// Why P.V starts from zero in every key tile. The tensor cores add each
// k16 step's products into the f32 accumulator rounding toward zero, so
// an accumulator carried across the whole row (O += P.V tile after tile)
// loses up to an ulp of |O| a step, all of one sign: 16 steps a tile, up
// to 64 tiles at S = 8192. Where the output cancels to near 0 (a peaked
// softmax over large v), that is an absolute error of ~2e-5, twice the
// check's 1e-5 floor: llava-next-34b's layer 0 at S = 8192 failed the
// element-wise check at 11 of 117 M elements, all in rows past 4800, on
// an H100. So each tile's P.V goes into a fresh accumulator, and O =
// O * alpha + O_t is folded in f32 on the CUDA cores (the emulation with
// truncation, tests/test_torch_zoo_kernels.py, shows both). O_t is taken
// one 64-column half of hd at a time (m64n64k16, 32 registers): a whole
// 128-column O_t beside O and the split P needs more registers than a
// thread of this 288-thread block has, and spilled.
//
// What bounds it on an H100: at h2o-danube-3-4b's layer shape (B = 2,
// S = 8192, H = 32, KH = 8, hd = 120, causal, window 4096) the unmasked
// (q, k) pairs are 25.2 M per (b, h), 4 hd FLOPs each: 7.7e11 FLOPs a
// call against ~157 MB of q, k, v and out, 0.78 ms at the bf16 tensor-
// core peak and 0.05 ms of memory, so the operations bound it. The split
// P costs one more P.V product: 2 x 128 + 4 x 120 = 736 tensor-core FLOPs
// per pair in place of 480 (a floor of ~1.2 ms), plus the softmax on the
// CUDA cores, which this first version does not overlap with the
// products of its own warpgroup (the other warpgroup's products run
// meanwhile).
//
// Design (at the default block shape, kBQ = kBK = 128; the others
// below): one block per (query tile of 128 rows, head, batch); 288
// threads: warps 0-7 are two consumer warpgroups of 64 query rows each,
// warp 8 the producer, whose lane 0 issues every TMA load. Q is loaded
// once; K and V go through a ring of kStages stages, one "full" mbarrier
// per stage (TMA bytes) and one "empty" one (one arrival per consumer
// warp). Tensor maps are 4-D over (hd, H or KH, S, B) with the caller's
// strides; 128-byte swizzle, so a row of hd <= 128 is two boxes of 64
// columns; columns from hd up to 128 arrive zero-filled (out of bounds)
// and add nothing to q . k, rows past Sq or Sk arrive as zeros. For
// hd <= 64 the second box is not loaded and its shared memory is zeroed
// once. Per key tile of kBK = 128 keys, each consumer warpgroup:
//   S = Q K^T      8 x wgmma m64n128k16 (m64n64k16 at kBK = 64), Q and K
//                  K-major from shared memory
//   mask, online softmax in f32 in the log2 domain (exp2), O *= alpha;
//                  only tiles that cross Sk, the diagonal or the window's
//                  lower edge pay for the position compare
//   O_t = P_hi V + P_lo V  per 64-column half of hd: 2 kBK / 16 x wgmma
//                  m64n64k16 from zero, P from registers (the S
//                  accumulator fragment is the A fragment of each k16
//                  slice), V MN-major (wgmma's transpose bit for B); then
//                  O = O * alpha + O_t on the CUDA cores
// Key tiles wholly outside the causal window are skipped (the TPU kernel
// only masks them), which is exact for every row that sees a key; the
// wrapper checks that each row does. Epilogue: O / max(l, 1e-30) ->
// bf16, stored at rows < Sq and columns < hd.
//
// Block shapes. The kernel is a template over (kBQ, kBK), the query rows
// of a block and the keys of a tile, as the TPU kernel takes (block_q,
// block_k) for its tile-size autotuner; the wrapper's
// `block_candidates` lists the instantiations and the entry point
// launches the one asked for. kBQ = 128 is two consumer warpgroups (288
// threads), kBQ = 64 one (160 threads); kBK = 128 is Q.K^T by m64n128k16
// (64 score registers a thread) and a P.V 128 keys deep, kBK = 64 by
// m64n64k16 (32) and 64 deep. The TMA boxes are kBQ and kBK rows, the
// ring kStages = 2 stages of one K and one V tile, one full and one empty
// mbarrier a stage (the empty one counts kBQ / 16 consumer warps):
//
//     (kBQ, kBK)   shared memory (+1 KB)      blocks an SM by smem
//     (128, 128)   32 + 2 x 64 = 160 KB        1
//     (128, 64)    32 + 2 x 32 =  96 KB        1 (288 threads at 168 regs)
//     (64, 128)    16 + 2 x 64 = 144 KB        1
//     (64, 64)     16 + 2 x 32 =  80 KB        2 (launch bounds ask for 2)
//
// all four within the 227 KB (232,448 bytes) a block may take, so all
// four ship. The (128, 128) instantiation is the kernel as it was before
// the template: kBQ = 128 query rows (2 x 64), kBK = 128 keys, hd padded
// to 128, kStages = 2: 32 KB of Q + 2 x (32 KB K + 32 KB V) = 160 KB of
// dynamic shared memory (+ 1 KB for 1024-byte alignment and barriers),
// one block per SM (4096 blocks at the layer shape), 168 registers a
// thread, the most a 9-warp block gets (three warps share an SM
// quarter's 16 K registers), with 160 bytes of spill stores since the
// per-tile O_t (`-Xptxas -v`, CUDA 12.8): 3-5 % slower than the kernel
// that carried O across the row, a 128-column O_t 16 % (H100 80GB HBM3,
// 700 W, the layer shapes of chip_smoke.py). The other shapes are right,
// not tuned: chip_smoke.py's [examples] phase times each beside the
// plain version and SDPA (PERF.md).
//
// The PTX helpers and the tensor-map encoder are wgmma_bf16.cuh's.
#include "wgmma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemPerSm = 233472;        // 228 KB an SM, 1 KB of it a block's

// the sizes of the (BQ, BK) instantiation
template <int BQ, int BK>
struct Tile {
  static_assert((BQ == 64 || BQ == 128) && (BK == 64 || BK == 128),
                "block shapes of 64 or 128 rows");
  static constexpr int kStages = 2;
  static constexpr int kConsumerWarps = BQ / 16;      // BQ / 64 warpgroups
  static constexpr int kThreads = 32 * (kConsumerWarps + 1);
  static constexpr int kQChunk = BQ * kBoxCols * 2;   // BQ rows x 128 B
  static constexpr int kKVChunk = BK * kBoxCols * 2;  // BK rows x 128 B
  static constexpr int kQBytes = 2 * kQChunk;         // Q: two column boxes
  static constexpr int kKVBytes = 2 * kKVChunk;       // one K or V tile
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + kStages * 2 * kKVBytes + 64 * sizeof(uint64_t);
  static_assert(kSmemBytes <= 232448, "a block takes at most 227 KB");
  static constexpr int kMinBlocks =
      BQ == 64 && 2 * (kSmemBytes + 1024) <= kSmemPerSm ? 2 : 1;
  static constexpr int kScores = BK / 2;      // S registers a thread
  static constexpr int kSlices = BK / 16;     // k16 slices of a key tile
};

#define WG_D64                                                          \
  WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),       \
      WG_D8(48), WG_D8(56)
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64x128] (+)= A[64x16] B[16x128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] B[16x64]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

struct Shape {
  int Sq, Sk, hd, kv_group, causal, window, q_offset;
  float scale_log2;              // scale * log2(e)
  int64_t osb, oss, osh;         // out strides (elements)
};

template <int BQ, int BK>
__global__ void __launch_bounds__(Tile<BQ, BK>::kThreads,
                                  Tile<BQ, BK>::kMinBlocks)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ out,
                            const Shape sh) {
  using T = Tile<BQ, BK>;
  constexpr int kBQ = BQ, kBK = BK, kStages = T::kStages;
  constexpr int kConsumerWarps = T::kConsumerWarps;
  constexpr int kThreads = T::kThreads;
  constexpr int kQChunk = T::kQChunk, kKVChunk = T::kKVChunk;
  constexpr int kQBytes = T::kQBytes, kKVBytes = T::kKVBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                             // [2 boxes][kBQ][64]
  uint8_t* kv_s = q_s + kQBytes;                   // [stage][K, V]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + kStages * 2 * kKVBytes);
  const uint32_t q_bar = smem_addr(bars);
  const uint32_t full0 = smem_addr(bars + 1);      // full[s]  = full0 + 8 s
  const uint32_t empty0 = smem_addr(bars + 1 + kStages);

  // heaviest query tiles (most keys under a causal mask) first
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int q0 = q_tile * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / sh.kv_group;
  const int boxes = sh.hd > kBoxCols ? 2 : 1;

  const int qp_lo = sh.q_offset + q0;
  const int qp_hi = sh.q_offset + min(q0 + kBQ, sh.Sq) - 1;
  const int k_end = sh.causal ? min(sh.Sk, qp_hi + 1) : sh.Sk;
  const int k_begin = sh.window > 0 ? max(0, qp_lo - sh.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - t_begin;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (boxes == 1) {           // the second column box is never loaded
    for (int s = -1; s < 2 * kStages; ++s) {
      const int chunk = s < 0 ? kQChunk : kKVChunk;
      uint4* p = reinterpret_cast<uint4*>(
          (s < 0 ? q_s : kv_s + s * kKVBytes) + chunk);
      for (int e = tid; e < chunk / 16; e += kThreads)
        p[e] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 32 * kConsumerWarps) {
    // ---------------------------------------------------------- producer
    if (tid != 32 * kConsumerWarps) return;
    mbar_expect_tx(q_bar, boxes * kQChunk);
    for (int c = 0; c < boxes; ++c)
      tma_load(smem_addr(q_s + c * kQChunk), &tm_q, q_bar,
               c * kBoxCols, h, q0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (t_begin + i) * kBK;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, 2 * boxes * kKVChunk);
      uint8_t* k_s = kv_s + s * 2 * kKVBytes;
      uint8_t* v_s = k_s + kKVBytes;
      for (int c = 0; c < boxes; ++c) {
        tma_load(smem_addr(k_s + c * kKVChunk), &tm_k, full,
                 c * kBoxCols, kh, k0, b);
        tma_load(smem_addr(v_s + c * kKVChunk), &tm_v, full,
                 c * kBoxCols, kh, k0, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid / 128;                 // rows 64 wg .. 64 wg + 63
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int r = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + 16 * warp + r;   // and row0 + 8
  const int qpos0 = sh.q_offset + row0;
  const int wg_qlo = sh.q_offset + q0 + 64 * wg;
  const int wg_qhi = wg_qlo + 63;

  float o[64], s[T::kScores];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::kScores; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const uint32_t q_wg = smem_addr(q_s) + 64 * wg * 128;
  mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = (t_begin + i) * kBK;
    mbar_wait(full0 + 8 * st, (i / kStages) & 1);
    // this warpgroup's rows see no key of the tile: nothing to add
    const bool skip = (sh.causal && k0 > wg_qhi) ||
                      (sh.window > 0 && wg_qlo - (k0 + kBK - 1) >= sh.window);
    if (!skip) {
      const uint32_t k_s = smem_addr(kv_s + st * 2 * kKVBytes);
      const uint32_t v_s = k_s + kKVBytes;
      // S = Q K^T over 8 k16 slices (4 per column box)
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(s, desc(q_wg + (kk / 4) * kQChunk + col, 16, 1024),
                 desc(k_s + (kk / 4) * kKVChunk + col, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);

      // scale, mask, online softmax (rows row0 and row0 + 8)
      const bool edge = k0 + kBK > sh.Sk || (sh.causal && k0 + kBK - 1 > wg_qlo) ||
                        (sh.window > 0 && wg_qhi - k0 >= sh.window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * sh.scale_log2;
          if (edge) {
            const int kp = k0 + 8 * j + c2 + (e & 1);
            const int qp = qpos0 + (e >> 1) * 8;
            const bool valid = kp < sh.Sk && (!sh.causal || kp <= qp) &&
                               (sh.window <= 0 || qp - kp < sh.window);
            if (!valid) x = kNegInf;
          }
          s[4 * j + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[4 * j] = exp2f(s[4 * j] - mn0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;        // this thread's columns; summed at the end
      l1 = l1 * a1 + sum1;

      // P split into bf16 halves, in the A-fragment layout of each k16
      uint32_t p_hi[T::kSlices][4], p_lo[T::kSlices][4];
#pragma unroll
      for (int kk = 0; kk < T::kSlices; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split2(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], p_hi[kk][f],
                 p_lo[kk][f]);

      // per 64-column half c of hd (V's column box c): O_t = P_hi V +
      // P_lo V over kBK / 16 k16 slices of 16 keys, from zero; then O = O *
      // alpha + O_t in f32 (O's fragment: columns 64 c + 8 j + ...)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float t[32];
        fence_regs(t);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < T::kSlices; ++kk) {
          const uint64_t dv =
              desc(v_s + c * kKVChunk + kk * 16 * 128, kKVChunk, 1024);
          wgmma_rs_t(t, p_hi[kk], dv, kk > 0);
          wgmma_rs_t(t, p_lo[kk], dv, 1);
        }
        wg_commit();
        wg_wait0();
        fence_regs(t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* oj = o + 32 * c + 4 * j;
          oj[0] = fmaf(oj[0], a0, t[4 * j]);
          oj[1] = fmaf(oj[1], a0, t[4 * j + 1]);
          oj[2] = fmaf(oj[2], a1, t[4 * j + 2]);
          oj[3] = fmaf(oj[3], a1, t[4 * j + 3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // epilogue: O / max(l, 1e-30) -> bf16, rows < Sq, columns < hd
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= sh.Sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* dst = out + b * sh.osb + row * sh.oss + h * sh.osh;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + c2;
      if (col < sh.hd)
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(
            o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
}

constexpr int kMaxDevices = 64;           // host settings cached per device
constexpr int kErrBlockShape = 30000;     // no instantiation of (block_q, block_k)

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, Sq, Sk, H, KH, hd;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

template <int BQ, int BK>
int launch(const Args& a) {
  using T = Tile<BQ, BK>;
  // the attribute applies to the current device only: set once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  const bool cached = cudaGetDevice(&dev) == cudaSuccess && dev >= 0 &&
                      dev < kMaxDevices;
  if (!cached || !configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_sm90_kernel<BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (cached) configured[dev] = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEntryPoint;
  CUtensorMap tq, tk, tv;
  int err = encode(fn, &tq, a.q, a.B, a.Sq, a.H, a.hd, a.qsb, a.qss, a.qsh,
                   BQ);
  if (!err)
    err = encode(fn, &tk, a.k, a.B, a.Sk, a.KH, a.hd, a.ksb, a.kss, a.ksh,
                 BK);
  if (!err)
    err = encode(fn, &tv, a.v, a.B, a.Sk, a.KH, a.hd, a.vsb, a.vss, a.vsh,
                 BK);
  if (err) return err;
  const Shape sh{a.Sq, a.Sk, a.hd, a.H / a.KH, a.causal, a.window,
                 a.q_offset, a.scale * kLog2e, a.osb, a.oss, a.osh};
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_attention_sm90_kernel<BQ, BK>
      <<<grid, T::kThreads, T::kSmemBytes, a.stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), sh);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Sq,H,hd], k/v [B,Sk,KH,hd], out [B,Sq,H,hd], bf16 on the device,
// each given by its batch, sequence and head strides in elements (the
// head-dim axis contiguous; the wrapper checks TMA's alignment rules).
// hd <= 128; window 0 = none; (block_q, block_k) one of (128, 128),
// (128, 64), (64, 128), (64, 64). Launch on `stream`; return 0, a CUDA
// error, 10000 (no tensor-map encoder), 20000 + the encoder's CUresult
// or 30000 (no such block shape).
extern "C" int flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KH, int hd, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int64_t osb, int64_t oss, int64_t osh, int causal,
    int window, int q_offset, int block_q, int block_k, float scale,
    void* stream) {
  const Args a{q,   k,   v,   out, B,   Sq,  Sk,  H,      KH,       hd,
               qsb, qss, qsh, ksb, kss, ksh, vsb, vss,    vsh,      osb,
               oss, osh, causal, window, q_offset, scale,
               (cudaStream_t)stream};
  if (block_q == 128 && block_k == 128) return launch<128, 128>(a);
  if (block_q == 128 && block_k == 64) return launch<128, 64>(a);
  if (block_q == 64 && block_k == 128) return launch<64, 128>(a);
  if (block_q == 64 && block_k == 64) return launch<64, 64>(a);
  return kErrBlockShape;
}
