// flash_attention_hd256_tf32: the f32 forward attention of the LM zoo for
// head dims 128 < hd <= 256 (recurrentgemma-9b's local attention, hd 256)
// on Hopper's tensor cores, in split TF32 (wgmma), with its key and value
// tiles brought in by the bulk copy engine.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _attn_kernel) for f32 inputs at the head
// dims that flash_attention_tf32.cu (hd <= 128) does not take, in the
// model layout [B, S, H, hd] read through strides. For batch b, query
// head h (kv head h / (H / KH)) and query row i at q_pos = q_offset + i:
//
//     s[k]  = (f32(q[b,i,h,:]) * scale) . f32(k[b,k,kh,:])
//     s[k]  = -1e30 where k >= Sk, (causal) k > q_pos,
//             or (window) q_pos - k >= window
//     out   = sum_k exp(s[k] - m) v[b,k,kh,:] / max(sum_k exp(s[k] - m),
//             1e-30), carried as a running (max m, normalizer l, O) over
//             key tiles, stored in f32
//
// The arithmetic is flash_attention_tf32.cu's (its note has the numbers):
// both products in split TF32 (a = hi + lo, hi = rna(a), lo = rna(a -
// hi), a·b = hi·lo + lo·hi + hi·hi, the two corrections first and the
// hi·hi steps on top), P·V of each key tile into a fresh accumulator
// folded as O = O·alpha + O_t, exp(s - m) as exp2((s - m)·log2e), key
// tiles wholly outside the causal window skipped (the wrapper refuses a
// query row that sees no key), the position compare only on tiles that
// cross Sk, the diagonal or the window's lower edge.
//
// Precision at hd 256. The tensor cores add each k8 step into the f32
// accumulator truncated toward zero (the CPU emulation's model,
// tests/test_torch_zoo_kernels.py), an error that scales with the running
// sum. One accumulator carried over all 256 columns of Q·K^T (96 k8
// steps) fails the f32 limit |out - ref| <= 2e-5·|ref| + 5e-6 at q x 3
// in that emulation (1.40 of it at S = 256, MQA 2/1); so the head-dim sum
// runs in four fresh accumulators of 64 columns, added in f32 on the CUDA
// cores: 0.83 there (0.89 with two of 128 columns), 0.22 at q x 1. On the
// card (H100, kernels/flash_time.py --route hd256_f32, S = 1024, window
// 256, four seeds) the kernel lies 0.06-0.08 of the limit from the exact
// attention (float64 after q·scale) at q x 1 and 0.30-0.40 at q x 3,
// while PyTorch's f32 products (the plain version in f32) lie 0.18-0.24
// and 1.34-1.95 from it: the f32 checks hold the kernel against the exact
// attention (flash_attention_plain(exact=True)).
//
// What bounds it on an H100: at recurrentgemma-9b's layer (B = 2, S =
// 8192, H = 16, KH = 1, hd = 256, causal, window 2048) the unmasked (q, k)
// pairs are 469.8 M per head pair, 4 hd FLOPs each: 4.81e11 f32 FLOPs.
// Split TF32 issues three tf32 products per f32 product: 2.916 ms at the
// 495 TFLOP/s tf32 peak (7.18 ms at the fp32 CUDA cores' 67); q, k, v
// and out move 0.57 GB, 0.17 ms. So the operations bound it.
//
// Design (the traps, and what this kernel does about each):
//
// 1. Shared memory (227 KB a block). Split tiles take twice the f32
//    bytes: Q hi/lo of 64 rows x 256 columns is 128 KB, and the hd <= 128
//    kernel's plan (K hi/lo and V^T hi/lo of a 64-key tile resident
//    beside Q) would need 256 KB. Here one block takes 64 query rows (one
//    consumer warpgroup, 128 threads, and one producer warp: 160 threads,
//    up to 255 registers each), Q hi/lo stay resident, and keys come in
//    tiles of 32 whose four halves (K_lo, K_hi, V^T_lo, V^T_hi, 32 KB
//    each) stream through a ring of three 32 KB stages: 128 + 96 KB + 1 KB
//    for alignment and barriers = 225 KB, one block an SM.
// 2. tf32 wgmma reads both operands K-major only: V^T is written, split
//    and swizzled, by the pre-pass split_kv<256, 32> (flash_tf32.cuh),
//    once per call into a scratch that the wrapper allocates
//    ([b][kh][tile] -> K_hi | K_lo | Vt_hi | Vt_lo, zeros past hd and Sk),
//    with V^T's keys permuted within groups of 8 so that the score
//    accumulator is P's A fragment as it stands (vt_key). Every query
//    tile of a kv head reads those tiles (16 x 128 times at the layer).
// 3. Q: copied by cp.async straight into Q_hi's swizzled layout, then
//    Q·scale (formed in f32 after the cast, as the TPU kernel forms it)
//    split in place into Q_hi and Q_lo. Plain loads through registers took
//    49 K of a block's 474 K cycles at the layer, the copies 13 K.
// 4. The ring. The producer's bulk copies run in the order K_lo, K_hi,
//    V^T_lo, V^T_hi of each tile; a half waits for the stage the half
//    three before it held. Three stages hold both K halves during Q·K^T
//    and both V^T halves during P·V, with one half in flight beside them.
//    Q·K^T issues its hi·lo products (K_lo only) first, then waits for
//    K_hi and issues the rest; K_lo's stage is released as soon as those
//    first products are done, so that V^T_hi lands during Q·K^T. Then
//    K_hi of the next tile is the one copy on the critical path, and the
//    hi·lo products hide part of it.
// 5. Registers: O is 64 x 256 f32 over the warpgroup, 128 a thread;
//    beside it the four score accumulators (4 x 16), declared in the key
//    loop so that none lives across it (carried over, they spilled 88
//    bytes), then P hi/lo (32) and two 64-column chunks of O_t (2 x 32):
//    chunk c + 1's products run while chunk c is folded. ptxas (CUDA
//    12.8): 249 registers, 0 bytes spilled.
// 6. Grid (H, query tiles, B): the heads of one query tile run side by
//    side and read the same kv head's tiles at about the same time; the
//    heaviest query tiles (most keys under a causal mask) first.
//
// Per 32-key tile, the consumer warpgroup, with the cycles one block
// spends per tile at the layer (kernels/phase_clocks.py, block (0, 0, 0),
// 66 tiles; H100 at 1980 MHz):
//   S = Q K^T   96 x wgmma m64n32k8, both operands from shared memory:
//               per 64-column chunk c of the head dim, from zero, 8
//               hi·lo, then 8 lo·hi and 8 hi·hi; S = ((S0 + S1) + S2) + S3
//                                                                   2845
//   mask, online softmax in f32, P split into hi/lo A fragments       684
//   O_t = P V   per 64-column chunk of O: 12 x wgmma m64n64k8 from zero (4
//               hi·lo, 4 lo·hi, 4 hi·hi), A from registers; O = O·alpha +
//               O_t by an f32 FMA                                    1699
//   waiting for V and for K                                    246 + 341
// The SASS holds 144 HGMMA and 6 WARPGROUP.DEPBAR: no product waits for
// the one before it. Q·K^T's m64n32 products read 3 KB of shared memory
// each (A 2 KB, B 1 KB) for 16 cycles of tensor-core work: 288 KB a
// tile at ~100 bytes a cycle, so shared memory, not the tensor cores,
// sets its pace. Measured (H100 80GB HBM3, 700 W): 5.79-5.89 ms a call
// at the layer (kernels/flash_time.py, chip_smoke.py), 49.5-50.3 % of
// the bound, against 46.00-47.57 ms for the CUDA-core FMA kernel it
// replaces, timed in the same call.
// Epilogue: O / max(l, 1e-30), stored at rows < Sq and columns < hd.
//
// Host-side settings (the shared-memory attribute) are cached per device.
#include "flash_tf32.cuh"

namespace {

using namespace repro_torch;

constexpr int kHD = 256;                  // head dim of the tiles
constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 32;                   // keys per tile
constexpr int kQkCols = 64;               // head-dim columns of an S chunk
constexpr int kQkChunks = kHD / kQkCols;
constexpr int kSteps = kQkCols / 8;       // its k8 steps
constexpr int kPvChunks = kHD / 64;       // P·V: m64n64, 64 columns of O
constexpr int kPvBytes = 64 * 128;        // 64 rows of a V^T tile
constexpr int kStages = 3;
constexpr int kConsumers = kWgThreads;    // one consumer warpgroup
constexpr int kThreads = kConsumers + 32; // + the producer warp
constexpr int kHalf = kBK * kHD * 4;      // one split half of a key tile
constexpr int kQHalf = kBQ * kHD * 4;     // Q hi or Q lo
constexpr size_t kSmem =
    1024 + 2 * (size_t)kQHalf + kStages * (size_t)kHalf +
    2 * kStages * sizeof(uint64_t);
static_assert(kSmem <= 232448, "227 KB a block");
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int Sq, Sk, KH, hd, kv_group, causal, window, q_offset, n_tiles;
  int q_vec;                     // q's rows in 16-byte pieces: cp.async 16
  float scale;
  int64_t qsb, qss, qsh;         // q strides (elements)
  int64_t osb, oss, osh;         // out strides
};

// the consumer warpgroup's own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 16 bytes global -> shared, the first `src_bytes` (16 or 0) of them
// read and the rest zero-filled
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// the ring's stage of copy n (half n % 4 of tile n / 4) and the parity of
// that stage's (n / 3)-th use; the ring takes K_lo, K_hi, Vt_lo, Vt_hi,
// so its half j of a tile is the scratch's half j ^ 1
__device__ __forceinline__ int stage_of(int n) { return n % kStages; }
__device__ __forceinline__ uint32_t parity_of(int n) {
  return (n / kStages) & 1;
}

// O_t[64 x 64] = P[64 x 32] V^T[64 rows at vc_lo / vc_hi]^T in split TF32
// from zero, issued and committed: the correction terms first, the hi·hi
// steps on top
__device__ __forceinline__ void pv_issue(float (&ot)[32],
                                         const uint32_t (&p_hi)[4][4],
                                         const uint32_t (&p_lo)[4][4],
                                         uint32_t vc_lo, uint32_t vc_hi) {
  fence_regs(ot);
  wg_fence();
  mma_rs<0>(ot, p_hi[0], desc_sw128(vc_lo + kstep(0, kHD)));
#pragma unroll
  for (int g = 1; g < 4; ++g)
    mma_rs<1>(ot, p_hi[g], desc_sw128(vc_lo + kstep(g, kHD)));
#pragma unroll
  for (int g = 0; g < 4; ++g)
    mma_rs<1>(ot, p_lo[g], desc_sw128(vc_hi + kstep(g, kHD)));
#pragma unroll
  for (int g = 0; g < 4; ++g)
    mma_rs<1>(ot, p_hi[g], desc_sw128(vc_hi + kstep(g, kHD)));
  wg_commit();
}

// O's chunk c = O's chunk c · alpha + O_t (fragment rows r: a0, r + 8: a1)
__device__ __forceinline__ void fold(float (&o)[kHD / 2],
                                     const float (&ot)[32], int c, float a0,
                                     float a1) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
    o[32 * c + j] = fmaf(o[32 * c + j], (j & 2) ? a1 : a0, ot[j]);
}

#ifdef REPRO_PHASE_CLOCKS
// block (0, 0, 0)'s consumer thread 0: [0] start, [1] Q split, [2] first
// K_lo landed, [3]-[7] cycles summed over tiles (Q·K^T, softmax and
// split, V wait, P·V and fold, K wait: K_lo's and K_hi's), [8] end, [9]
// tiles
#define FLASH_CLOCK(stmt)                                               \
  do {                                                                  \
    if (clocked) { stmt; }                                              \
  } while (0)
#else
#define FLASH_CLOCK(stmt)
#endif

// ---------------------------------------------------------- main kernel
__global__ void __launch_bounds__(kThreads, 1)
flash_hd256_tf32(const float* __restrict__ q, const uint8_t* __restrict__ kv,
                 float* __restrict__ out, const Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_hi = smem_addr(smem);
  const uint32_t q_lo = q_hi + kQHalf;
  const uint32_t ring = q_hi + 2 * kQHalf;     // stage s at + s kHalf
  const uint32_t full0 = ring + kStages * kHalf;         // full[s]: + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;

  // heads side by side; the heaviest query tiles first
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kh = h / sh.kv_group;
  const int qp_lo = sh.q_offset + q0;
  const int qp_hi = sh.q_offset + min(q0 + kBQ, sh.Sq) - 1;
  const int k_end = sh.causal ? min(sh.Sk, qp_hi + 1) : sh.Sk;
  const int k_begin = sh.window > 0 ? max(0, qp_lo - sh.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - t_begin;

  // the warp index, broadcast so that the compiler knows it is uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x % 32) return;
    const uint8_t* src =
        kv + (((size_t)b * sh.KH + kh) * sh.n_tiles + t_begin) * 4 * kHalf;
    for (int n = 0; n < 4 * n_tiles; ++n) {
      const int s = stage_of(n);
      mbar_wait(empty0 + 8 * s, parity_of(n) ^ 1);
      mbar_expect_tx(full0 + 8 * s, kHalf);
      bulk_load(ring + s * kHalf,
                src + (size_t)(n / 4) * 4 * kHalf + ((n % 4) ^ 1) * kHalf,
                kHalf, full0 + 8 * s);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x;
  const int lane = tid % 32;
#ifdef REPRO_PHASE_CLOCKS
  const bool clocked = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                       blockIdx.z == 0;
  unsigned long long t_mark = clock64(), acc_clk[5] = {0, 0, 0, 0, 0};
  FLASH_CLOCK(repro_phase_clocks[0] = t_mark);
#define FLASH_LAP(slot)                                                 \
  FLASH_CLOCK({                                                         \
    const unsigned long long now = clock64();                           \
    acc_clk[slot] += now - t_mark;                                      \
    t_mark = now;                                                       \
  })
#else
#define FLASH_LAP(slot)
#endif

  // Q into the Q_hi tile's swizzled layout by cp.async (16-byte copies
  // where q's base, strides and hd allow, else 4-byte ones; zeros past Sq
  // and hd), then Q · scale split in place into Q_hi and Q_lo (the swizzle
  // permutes positions alike in both): trap 3
  {
    const float* qb = q + b * sh.qsb + h * sh.qsh;
    if (sh.q_vec) {
      for (int e = tid; e < kBQ * kHD / 4; e += kConsumers) {
        const int r = e / (kHD / 4), d = 4 * (e % (kHD / 4));
        const bool ok = q0 + r < sh.Sq && d < sh.hd;
        cp_async16_zfill(q_hi + sw128(r, d, kBQ),
                         ok ? qb + (int64_t)(q0 + r) * sh.qss + d : qb,
                         ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBQ * kHD; e += kConsumers) {
        const int r = e / kHD, d = e % kHD;
        const bool ok = q0 + r < sh.Sq && d < sh.hd;
        cp_async4(q_hi + sw128(r, d, kBQ),
                  ok ? qb + (int64_t)(q0 + r) * sh.qss + d : qb, ok ? 4 : 0);
      }
    }
    cp_async_wait_all();
    consumer_sync();
    float4* qh = reinterpret_cast<float4*>(smem);
    float4* ql = reinterpret_cast<float4*>(smem + kQHalf);
    for (int e = tid; e < kQHalf / 16; e += kConsumers) {
      const float4 x = qh[e];
      const float xs[4] = {x.x * sh.scale, x.y * sh.scale, x.z * sh.scale,
                           x.w * sh.scale};
      float hs[4], ls[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hs[j] = tf32_rna(xs[j]);
        ls[j] = tf32_rna(xs[j] - hs[j]);
      }
      qh[e] = make_float4(hs[0], hs[1], hs[2], hs[3]);
      ql[e] = make_float4(ls[0], ls[1], ls[2], ls[3]);
    }
    fence_proxy_async();
    consumer_sync();
  }
#ifdef REPRO_PHASE_CLOCKS
  FLASH_CLOCK(repro_phase_clocks[1] = clock64());
  t_mark = clock64();
#endif

  const int r = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + 16 * (tid / 32) + r;        // and row0 + 8
  const int qpos0 = sh.q_offset + row0;
  float o[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int n = 4 * i;                         // this tile's K_lo copy
    const int k0 = (t_begin + i) * kBK;
    const uint32_t k_lo = ring + stage_of(n) * kHalf;
    const uint32_t k_hi = ring + stage_of(n + 1) * kHalf;
    const uint32_t v_lo = ring + stage_of(n + 2) * kHalf;
    const uint32_t v_hi = ring + stage_of(n + 3) * kHalf;
    mbar_wait(full0 + 8 * stage_of(n), parity_of(n));
#ifdef REPRO_PHASE_CLOCKS
    if (i == 0) FLASH_CLOCK(repro_phase_clocks[2] = clock64());
#endif
    FLASH_LAP(4);

    // S = Q K^T per 64-column chunk c, each from zero (the first product
    // overwrites: the accumulators carry nothing from the last tile): hi·lo
    // (K_lo only), then, once K_hi has landed, lo·hi and hi·hi on top
    float sc[kQkChunks][16];
#pragma unroll
    for (int c = 0; c < kQkChunks; ++c) fence_regs(sc[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kQkChunks; ++c) {
      mma_ss<0>(sc[c], desc_sw128(q_hi + kstep(kSteps * c, kBQ)),
                desc_sw128(k_lo + kstep(kSteps * c, kBK)));
#pragma unroll
      for (int kk = kSteps * c + 1; kk < kSteps * (c + 1); ++kk)
        mma_ss<1>(sc[c], desc_sw128(q_hi + kstep(kk, kBQ)),
                  desc_sw128(k_lo + kstep(kk, kBK)));
    }
    wg_commit();
    FLASH_LAP(0);
    mbar_wait(full0 + 8 * stage_of(n + 1), parity_of(n + 1));
    FLASH_LAP(4);
    wg_fence();
#pragma unroll
    for (int c = 0; c < kQkChunks; ++c) {
#pragma unroll
      for (int kk = kSteps * c; kk < kSteps * (c + 1); ++kk)
        mma_ss<1>(sc[c], desc_sw128(q_lo + kstep(kk, kBQ)),
                  desc_sw128(k_hi + kstep(kk, kBK)));
#pragma unroll
      for (int kk = kSteps * c; kk < kSteps * (c + 1); ++kk)
        mma_ss<1>(sc[c], desc_sw128(q_hi + kstep(kk, kBQ)),
                  desc_sw128(k_hi + kstep(kk, kBK)));
    }
    wg_commit();
    wg_wait1();                  // the hi·lo products: K_lo is free
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage_of(n));
    wg_wait0();
#pragma unroll
    for (int c = 0; c < kQkChunks; ++c) fence_regs(sc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage_of(n + 1));
    float s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = sc[0][j];
#pragma unroll
      for (int c = 1; c < kQkChunks; ++c) s[j] += sc[c][j];
    }
    FLASH_LAP(0);

    // mask, online softmax (rows row0 and row0 + 8)
    const bool edge = k0 + kBK > sh.Sk ||
                      (sh.causal && k0 + kBK - 1 > qp_lo) ||
                      (sh.window > 0 && qp_hi - k0 >= sh.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kp = k0 + 8 * j + c2 + (e & 1);
          const int qp = qpos0 + (e >> 1) * 8;
          const bool valid = kp < sh.Sk && (!sh.causal || kp <= qp) &&
                             (sh.window <= 0 || qp - kp < sh.window);
          if (!valid) s[4 * j + e] = kNegInf;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f((m0 - mn0) * kLog2e);
    const float a1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    // p = exp(s - m), split into the A fragments of the 4 k8 slices
    // (registers 4g, 4g + 2, 4g + 1, 4g + 3 of group g: vt_key)
    uint32_t p_hi[4][4], p_lo[4][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = (e & 2) ? mn1 : mn0;
        const float p = exp2f((s[4 * g + e] - mn) * kLog2e);
        if (e & 2) sum1 += p;
        else sum0 += p;
        const float ph = tf32_rna(p);
        const int f = (e >> 1) | ((e & 1) << 1);     // 0, 2, 1, 3
        p_hi[g][f] = __float_as_uint(ph);
        p_lo[g][f] = __float_as_uint(tf32_rna(p - ph));
      }
    }
    l0 = l0 * a0 + sum0;        // this thread's columns; summed at the end
    l1 = l1 * a1 + sum1;
    FLASH_LAP(1);

    mbar_wait(full0 + 8 * stage_of(n + 2), parity_of(n + 2));
    mbar_wait(full0 + 8 * stage_of(n + 3), parity_of(n + 3));
    FLASH_LAP(2);
    // O_t = P V per 64-column chunk c of O (V^T rows 64c..), from zero,
    // then O = O·alpha + O_t; two O_t buffers, so that chunk c + 1's
    // products run while chunk c is folded
    static_assert(kPvChunks == 4, "the chunks below");
    float ot0[32], ot1[32];
    pv_issue(ot0, p_hi, p_lo, v_lo, v_hi);
    pv_issue(ot1, p_hi, p_lo, v_lo + kPvBytes, v_hi + kPvBytes);
    wg_wait1();
    fence_regs(ot0);
    fold(o, ot0, 0, a0, a1);
    pv_issue(ot0, p_hi, p_lo, v_lo + 2 * kPvBytes, v_hi + 2 * kPvBytes);
    wg_wait1();
    fence_regs(ot1);
    fold(o, ot1, 1, a0, a1);
    pv_issue(ot1, p_hi, p_lo, v_lo + 3 * kPvBytes, v_hi + 3 * kPvBytes);
    wg_wait1();
    fence_regs(ot0);
    fold(o, ot0, 2, a0, a1);
    wg_wait0();
    fence_regs(ot1);
    fold(o, ot1, 3, a0, a1);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty0 + 8 * stage_of(n + 2));
      mbar_arrive(empty0 + 8 * stage_of(n + 3));
    }
    FLASH_LAP(3);
  }

  // epilogue: O / max(l, 1e-30), rows < Sq, columns < hd (l >= 1: the
  // largest term of a row that sees a key is exp(0))
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= sh.Sq) continue;
    const float l = half ? l1 : l0, inv = half ? inv1 : inv0;
    float* dst = out + b * sh.osb + (int64_t)row * sh.oss + h * sh.osh;
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c2 + e;
        if (col < sh.hd) dst[col] = div_by(o[4 * j + 2 * half + e], l, inv);
      }
    }
  }
#ifdef REPRO_PHASE_CLOCKS
  FLASH_CLOCK({
    for (int p = 0; p < 5; ++p) repro_phase_clocks[3 + p] = acc_clk[p];
    repro_phase_clocks[8] = clock64();
    repro_phase_clocks[9] = n_tiles;
  });
#undef FLASH_LAP
#endif
}
#undef FLASH_CLOCK

long long key_tiles(int Sk) { return (Sk + kBK - 1) / kBK; }

}  // namespace

// bytes of the K / V^T hi/lo scratch that flash_attention_hd256_tf32 needs
extern "C" long long flash_attention_hd256_tf32_scratch_bytes(int B, int Sk,
                                                               int KH,
                                                               int hd) {
  (void)hd;                      // the tiles are 256 columns at any hd
  return (long long)B * KH * key_tiles(Sk) * 4 * kHalf;
}

// q [B,Sq,H,hd], k/v [B,Sk,KH,hd], out [B,Sq,H,hd], f32 on the device,
// each given by its batch, sequence and head strides in elements (the
// head-dim axis contiguous); `scratch` of flash_attention_hd256_tf32_
// scratch_bytes, 16-byte aligned. 128 < hd <= 256 (any hd <= 256 works);
// window 0 = none. Launches split_kv, then the attention kernel, on
// `stream`; returns cudaGetLastError() (or the error of setting the
// shared-memory attribute).
extern "C" int flash_attention_hd256_tf32(
    const float* q, const float* k, const float* v, float* out,
    void* scratch, int B, int Sq, int Sk, int H, int KH, int hd,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, int causal, int window, int q_offset,
    float scale, void* stream) {
  static bool configured[kMaxDevices] = {};
  const int slot = cached_device();
  if (slot < 0 || !configured[slot]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_hd256_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    if (slot >= 0) configured[slot] = true;
  }
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  uint8_t* kv = static_cast<uint8_t*>(scratch);
  const int n_tiles = (int)key_tiles(Sk);
  const KVShape ks{Sk, KH, hd, n_tiles, ksb, kss, ksh, vsb, vss, vsh};
  split_kv<kHD, kBK><<<dim3(n_tiles, KH, B), kSplitThreads, 0, cs>>>(
      k, v, kv, ks);
  const int q_vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    qsb % 4 == 0 && qss % 4 == 0 && qsh % 4 == 0 &&
                    hd % 4 == 0;
  const Shape sh{Sq,     Sk,    KH,  hd,  H / KH, causal, window,
                 q_offset, n_tiles, q_vec, scale, qsb, qss, qsh,
                 osb,    oss,   osh};
  flash_hd256_tf32<<<dim3(H, (Sq + kBQ - 1) / kBQ, B), kThreads, kSmem,
                     cs>>>(q, kv, out, sh);
  return (int)cudaGetLastError();
}
