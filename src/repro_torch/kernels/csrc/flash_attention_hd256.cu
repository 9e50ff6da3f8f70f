// flash_attention_hd256: forward attention of the LM zoo for head dims
// 128 < hd <= 256 (recurrentgemma-9b's local attention, hd 256) in bf16,
// on Hopper's tensor cores (wgmma, tiles brought in by TMA); f32 takes
// flash_attention_hd256_tf32.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _attn_kernel) for the head dims that the
// hd <= 128 routes (flash_attention_sm90.cu, flash_attention_tf32.cu)
// do not take, in the model layout [B, S, H, hd] read through strides.
// For batch b, query head h (kv head h / (H / KH)) and query row i at
// position q_pos = q_offset + i:
//
//     s[k]  = (f32(q[b,i,h,:]) . f32(k[b,k,kh,:])) * scale
//     s[k]  = -1e30 where k >= Sk, (causal) k > q_pos,
//             or (window) q_pos - k >= window
//     out   = sum_k exp(s[k] - m) v[b,k,kh,:] / max(sum_k exp(s[k] - m),
//             1e-30), carried as a running (max m, normalizer l, O) over
//             key tiles, stored in bf16
//
// Key tiles wholly outside the causal window are skipped: at
// recurrentgemma-9b's layer (S = 8192, window 2048) a block of 128 query
// rows walks at most 34 of up to 128 key tiles of 64. That is exact for
// every query row that sees a key; the wrapper refuses inputs with a row
// that sees none.
//
// What bounds it on an H100: at that layer (B = 2, S = 8192, H = 16,
// KH = 1, hd = 256, causal, window 2048) the unmasked (q, k) pairs are
// 469.8 M per head pair, 4 hd FLOPs each: 4.81e11 FLOPs, 0.486 ms at
// the bf16 tensor-core peak (989 TFLOP/s); q, k, v and out move 0.14 GB,
// 0.04 ms. So the operations bound it.
//
// bf16 (flash_hd256_bf16). Issued tensor-core work: Q·K^T once over all
// 256 columns (2 hd FLOPs a pair) and P·V twice, for P's two bf16
// halves (4 hd): 6 hd a pair, 1.5x the bound's 4 hd, and the walked
// tiles' masked pairs on top (1.08x at the layer): a floor of 0.79 ms.
//
// Why P is split, and why P·V starts from zero in every key tile (both
// as in flash_attention_sm90.cu, whose note has the numbers): P rounded
// once to bf16 fails the element-wise check |out - ref| <= 2^-6·|ref| +
// 1e-5 by ~50x, so P = p_hi + p_lo, two bf16 halves, and P·V takes both;
// the tensor cores add each k16 step into the f32 accumulator rounding
// toward zero, which carried across a row of 2048 keys fails the check
// at near-zero outputs, so each key tile's P·V goes into a fresh
// accumulator O_t, folded in f32 on the CUDA cores as O = O·alpha + O_t
// (tests/test_torch_zoo_kernels.py emulates both at hd 256).
//
// Design: one block per (128 query rows, head, batch), grid (ceil(Sq /
// 128), H, B), the heaviest query tiles (most keys under the causal
// mask) first. 384 threads: warpgroups 0 and 1 are consumers of 64 query
// rows each, warpgroup 2 the producer, whose thread 0 issues every TMA
// load. Tensor maps are 4-D over (hd, H or KH, S, B) with the caller's
// strides, boxes of 64 columns x 64 rows with the 128-byte swizzle: a
// row of 256 columns is four boxes; columns from hd up to the last
// loaded box arrive zero-filled, and for hd <= 192 the fourth box is
// never loaded and its shared memory is zeroed once; rows past Sq or Sk
// arrive as zeros. Q is loaded once (a warpgroup whose rows all lie
// past Sq loads and computes nothing); K and V go through two stages,
// one "full" mbarrier a stage (TMA bytes) and one "empty" one (one
// arrival per consumer warp). Per key tile of kBK = 64 keys, each
// consumer warpgroup:
//   S = Q K^T      16 x wgmma m64n64k16 over all 256 columns, Q and K
//                  K-major from shared memory
//   mask, online softmax in f32 in the log2 domain (exp2); only tiles
//                  that cross Sk, the diagonal or the window's lower edge
//                  pay for the position compare
//   P split        into bf16 hi and lo A fragments (the S accumulator's
//                  registers are the A fragment of each k16 slice)
//   O_t = P_hi V + P_lo V  per 64-column chunk of V: 8 x wgmma
//                  m64n64k16 from zero, A from registers, V MN-major
//                  (wgmma's transpose bit); then O = O·alpha + O_t on the
//                  CUDA cores
// A tile that none of the warpgroup's rows sees is skipped. Epilogue:
// O / max(l, 1e-30) -> bf16, stored at rows < Sq and columns < hd.
//
// Shared memory: Q 128 x 256 bf16 (64 KB) + 2 stages x (K 32 KB + V 32
// KB) = 192 KB, + 1 KB for 1024-byte alignment and barriers: one block
// an SM. Registers: O is 64 x 256 f32 over a warpgroup, 128 a thread;
// beside it S (32), then P hi/lo (32) and one chunk's O_t (32). A
// 384-thread block gets 168 registers a thread at launch (three warps
// share an SM quarter's 16 K registers); setmaxnreg shrinks the producer
// to 24 and grows the consumers to 240. ptxas (-Xptxas -v, CUDA 12.8):
// 168 registers at entry, 0 bytes of spill stores and loads. The SASS
// holds 48 HGMMA and 5 WARPGROUP.DEPBAR, one wait per product group: no
// product waits for the one before it.
//
// Measured on an H100 80GB HBM3 at 700 W, at the layer: 1.25 ms a call
// (chip_smoke.py 1.2507; kernels/flash_time.py 1.2409-1.2641 beside the
// mma.sync kernel it replaces, which took 4.629-4.710 in the same calls),
// 38.9 % of the bound, 385 TFLOP/s of the bound's FLOPs; SDPA 8.36 ms;
// worst element 0.495 of the limit. One block (kernels/phase_clocks.py,
// block (0, 0, 0), its first warpgroup: 34 key tiles walked, 33
// computed), cycles per computed tile in two calls: Q·K^T 687 / 1176,
// softmax and P split 1633 / 1309, P·V and the fold 1954 / 1761; waiting
// for K and V 295 / 413 a tile walked. The tensor-core work of a tile is
// 48 products of at least 32 cycles a warpgroup, 3072 for the two: 60 %
// of the 5137 cycles a tile takes (174.7 K over the block's 34). The
// softmax, which leaves its own warpgroup's products idle, is the next
// lever.
//
// The PTX helpers and the tensor-map encoder are wgmma_bf16.cuh's.
#include "wgmma_bf16.cuh"

#ifdef REPRO_PHASE_CLOCKS
// block (0, 0, 0)'s consumer thread 0, for a build with
// -DREPRO_PHASE_CLOCKS only (kernels/phase_clocks.py): [0] start, [1] Q
// landed, [2] first key tile landed, [3]-[6] cycles summed over tiles
// (waiting for K and V, Q·K^T, softmax and P split, P·V and the fold),
// [8] end, [9] tiles walked, [10] tiles computed
__device__ unsigned long long repro_phase_clocks[16];
extern "C" int repro_read_phase_clocks(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, repro_phase_clocks,
                                   sizeof(repro_phase_clocks));
}
#endif

namespace {

constexpr int kHdMax = 256;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// ------------------------------------------------------------------ bf16
constexpr int kBQ = 128;                  // query rows a block
constexpr int kBK = 64;                   // keys a tile
constexpr int kBoxes = kHdMax / kBoxCols; // column boxes of a row
constexpr int kBoxBytes = 64 * 128;       // 64 rows x 128 bytes
constexpr int kTileBytes = kBoxes * kBoxBytes;   // 64 rows x 256 columns
constexpr int kStages = 2;
constexpr int kConsumerWgs = 2;           // 64 query rows each
constexpr int kWgThreads = 128;
constexpr int kThreadsBf16 = kWgThreads * (kConsumerWgs + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr size_t kSmemBf16 = 1024 + kConsumerWgs * kTileBytes +
                             kStages * 2 * kTileBytes +
                             (1 + 2 * kStages) * sizeof(uint64_t);
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kConsumerWgs * 64 && kBK == 64, "boxes of 64 rows");

// a warpgroup's register budget, in place of the launch's 168 a thread
template <int N>
__device__ __forceinline__ void regs_shrink() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_grow() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

struct ShapeTc {
  int Sq, Sk, hd, kv_group, causal, window, q_offset;
  float scale_log2;              // scale * log2(e)
  int64_t osb, oss, osh;         // out strides (elements)
};

#ifdef REPRO_PHASE_CLOCKS
#define FLASH_CLOCK(stmt)                                               \
  do {                                                                  \
    if (clocked) { stmt; }                                              \
  } while (0)
#define FLASH_LAP(slot)                                                 \
  FLASH_CLOCK({                                                         \
    const unsigned long long now = clock64();                           \
    acc_clk[slot - 3] += now - t_mark;                                  \
    t_mark = now;                                                       \
  })
#else
#define FLASH_CLOCK(stmt)
#define FLASH_LAP(slot)
#endif

__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_hd256_bf16(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ out, const ShapeTc sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                     // [warpgroup][box][64 rows][128 B]
  uint8_t* kv_s = q_s + kConsumerWgs * kTileBytes;   // [stage][K, V][box]..
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + kStages * 2 * kTileBytes);
  const uint32_t q_bar = smem_addr(bars);
  const uint32_t full0 = smem_addr(bars + 1);      // full[s]  = full0 + 8 s
  const uint32_t empty0 = smem_addr(bars + 1 + kStages);

  // heaviest query tiles (most keys under a causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / sh.kv_group;
  const int boxes = (sh.hd + kBoxCols - 1) / kBoxCols;   // 3 or 4

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
      mbar_init(empty0 + 8 * s, kConsumerWgs * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (boxes < kBoxes) {       // the fourth column box is never loaded
    for (int t = 0; t < kConsumerWgs + 2 * kStages; ++t) {
      uint4* p = reinterpret_cast<uint4*>(q_s + t * kTileBytes +
                                          (kBoxes - 1) * kBoxBytes);
      for (int e = tid; e < kBoxBytes / 16; e += kThreadsBf16)
        p[e] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler knows it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  if (wg == kConsumerWgs) {
    // ---------------------------------------------------------- producer
    regs_shrink<kProducerRegs>();
    if (tid != kConsumerWgs * kWgThreads) return;
    int q_boxes = 0;
    for (int w = 0; w < kConsumerWgs; ++w)
      q_boxes += q0 + 64 * w < sh.Sq ? boxes : 0;
    mbar_expect_tx(q_bar, q_boxes * kBoxBytes);
    for (int w = 0; w < kConsumerWgs; ++w) {
      if (q0 + 64 * w >= sh.Sq) continue;
      for (int c = 0; c < boxes; ++c)
        tma_load(smem_addr(q_s + w * kTileBytes + c * kBoxBytes), &tm_q,
                 q_bar, c * kBoxCols, h, q0 + 64 * w, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (t_begin + i) * kBK;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, 2 * boxes * kBoxBytes);
      uint8_t* k_s = kv_s + s * 2 * kTileBytes;
      uint8_t* v_s = k_s + kTileBytes;
      for (int c = 0; c < boxes; ++c) {
        tma_load(smem_addr(k_s + c * kBoxBytes), &tm_k, full, c * kBoxCols,
                 kh, k0, b);
        tma_load(smem_addr(v_s + c * kBoxBytes), &tm_v, full, c * kBoxCols,
                 kh, k0, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_grow<kConsumerRegs>();
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int r = lane / 4, c2 = 2 * (lane % 4);
  const int wq0 = q0 + 64 * wg;                    // the warpgroup's rows
  const int row0 = wq0 + 16 * warp + r;            // and row0 + 8
  const int qpos0 = sh.q_offset + row0;
  const bool active = wq0 < sh.Sq;                 // some row below Sq
  const int wg_qlo = sh.q_offset + wq0;
  const int wg_qhi = sh.q_offset + min(wq0 + 64, sh.Sq) - 1;
#ifdef REPRO_PHASE_CLOCKS
  const bool clocked = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                       blockIdx.z == 0;
  unsigned long long t_mark = clock64(), acc_clk[4] = {0, 0, 0, 0};
  unsigned long long computed = 0;
  FLASH_CLOCK(repro_phase_clocks[0] = t_mark);
#endif

  float o[4 * 32], s[32];
#pragma unroll
  for (int i = 0; i < 4 * 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const uint32_t q_wg = smem_addr(q_s) + wg * kTileBytes;
  mbar_wait(q_bar, 0);
  FLASH_CLOCK(repro_phase_clocks[1] = clock64());
#ifdef REPRO_PHASE_CLOCKS
  t_mark = clock64();
#endif

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = (t_begin + i) * kBK;
    mbar_wait(full0 + 8 * st, (i / kStages) & 1);
    FLASH_CLOCK(if (i == 0) repro_phase_clocks[2] = clock64());
    FLASH_LAP(3);
    // this warpgroup's rows see no key of the tile: nothing to add
    const bool skip = !active || (sh.causal && k0 > wg_qhi) ||
                      (sh.window > 0 && wg_qlo - (k0 + kBK - 1) >= sh.window);
    if (!skip) {
      const uint32_t k_s = smem_addr(kv_s + st * 2 * kTileBytes);
      const uint32_t v_s = k_s + kTileBytes;
      // S = Q K^T over 16 k16 slices of the 256 columns (4 per box)
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss(s, desc(q_wg + off, 16, 1024), desc(k_s + off, 16, 1024),
                 kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);
      FLASH_LAP(4);

      // scale, mask, online softmax (rows row0 and row0 + 8)
      const bool edge = k0 + kBK > sh.Sk ||
                        (sh.causal && k0 + kBK - 1 > wg_qlo) ||
                        (sh.window > 0 && wg_qhi - k0 >= sh.window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
      for (int j = 0; j < 8; ++j) {
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
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split2(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], p_hi[kk][f],
                 p_lo[kk][f]);
      FLASH_LAP(5);

      // per 64-column chunk c of hd (V's column box c): O_t = P_hi V +
      // P_lo V over 4 k16 slices of 16 keys, from zero; then O = O *
      // alpha + O_t in f32 (O's fragment: columns 64 c + 8 j + ...)
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        float t[32];
        fence_regs(t);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv =
              desc(v_s + c * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024);
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
      FLASH_LAP(6);
#ifdef REPRO_PHASE_CLOCKS
      ++computed;
#endif
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
    for (int j = 0; j < 4 * 8; ++j) {
      const int col = 8 * j + c2;        // o[4 j ..]: chunk j / 8, group j % 8
      if (col < sh.hd)
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(
            o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
  FLASH_CLOCK({
    for (int p = 0; p < 4; ++p) repro_phase_clocks[3 + p] = acc_clk[p];
    repro_phase_clocks[8] = clock64();
    repro_phase_clocks[9] = n_tiles;
    repro_phase_clocks[10] = computed;
  });
}
#undef FLASH_LAP
#undef FLASH_CLOCK

// the kernel's dynamic shared memory, set once per device (the attribute
// applies to the current device only); 0 or a CUDA error
int configure(const void* kernel, bool* configured, int smem) {
  int dev = 0;
  const bool cached = cudaGetDevice(&dev) == cudaSuccess && dev >= 0 &&
                      dev < kMaxDevices;
  if (cached && configured[dev]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (cached) configured[dev] = true;
  return 0;
}

}  // namespace

// q [B,Sq,H,hd], k/v [B,Sk,KH,hd], out [B,Sq,H,hd], bf16 on the device,
// each given by its batch, sequence and head strides in elements (the
// head-dim axis contiguous), 128 < hd <= 256 and hd a multiple of 8;
// 16-byte aligned base pointers and strides that are multiples of 8
// elements (the wrapper checks TMA's rules). window 0 = none. Launches on
// `stream`; returns 0, a CUDA error, 10000 (no tensor-map encoder) or
// 20000 + the encoder's CUresult.
#define FLASH_HD256_ARGS                                                      \
  const void *q, const void *k, const void *v, void *out, int B, int Sq,      \
      int Sk, int H, int KH, int hd, int64_t qsb, int64_t qss, int64_t qsh,   \
      int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,        \
      int64_t vsh, int64_t osb, int64_t oss, int64_t osh, int causal,         \
      int window, int q_offset, float scale, void *stream

extern "C" int flash_attention_hd256_bf16(FLASH_HD256_ARGS) {
  static bool configured[kMaxDevices] = {};
  int err = configure((const void*)flash_hd256_bf16, configured,
                      (int)kSmemBf16);
  if (err) return err;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEntryPoint;
  CUtensorMap tq, tk, tv;
  err = encode(fn, &tq, q, B, Sq, H, hd, qsb, qss, qsh, kBQ / kConsumerWgs);
  if (!err) err = encode(fn, &tk, k, B, Sk, KH, hd, ksb, kss, ksh, kBK);
  if (!err) err = encode(fn, &tv, v, B, Sk, KH, hd, vsb, vss, vsh, kBK);
  if (err) return err;
  const ShapeTc sh{Sq, Sk, hd, H / KH, causal, window, q_offset,
                   scale * kLog2e, osb, oss, osh};
  flash_hd256_bf16<<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreadsBf16,
                     kSmemBf16, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), sh);
  return (int)cudaGetLastError();
}
