// flash_attention_tf32: the f32 forward attention of the LM zoo on
// Hopper's tensor cores, in split TF32 (wgmma), with its key and value
// tiles brought in by the bulk copy engine.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _attn_kernel) for f32 inputs, in the model
// layout [B, S, H, hd] read through strides, hd <= 128. For batch b,
// query head h (kv head h / (H / KH)) and query row i at position
// q_pos = q_offset + i:
//
//     s[k]  = (f32(q[b,i,h,:]) * scale) . f32(k[b,k,kh,:])
//     s[k]  = -1e30 where k >= Sk, (causal) k > q_pos,
//             or (window) q_pos - k >= window
//     out   = sum_k exp(s[k] - m) v[b,k,kh,:] / max(sum_k exp(s[k] - m),
//             1e-30), carried as a running (max m, normalizer l, O) over
//             key tiles, stored in f32
//
// q is scaled in f32 after the cast and before the product, as the TPU
// kernel scales it.
//
// Precision. A tf32 operand keeps 11 significant bits, so one tf32
// product per f32 product misses the f32 check |out - ref| <=
// 2e-5·|ref| + 5e-6 by two orders of magnitude: exp turns an error in a
// score into a relative error of p. Both products are therefore taken in
// split TF32 (tf32_mma.cuh): a = hi + lo, hi = rna(a), lo = rna(a - hi),
// a·b = hi·hi + hi·lo + lo·hi. The CPU emulation
// (tests/test_torch_zoo_kernels.py, `_emulate_split_tf32_flash`), against
// the plain version at S = 256, H/KH = 4/1, hd = 120, window 100, worst
// |Δ| / limit over the elements:
//
//     both products split TF32          0.16   (q x 3: 0.71)
//     one tf32 product for Q·K^T      109
//     one tf32 product for P·V         74
//
// On the card (H100, chip_smoke.py): 0.155 of the limit at S = 1024,
// 0.205 at the layer shape, 0.990 at q x 3, where much of it is the
// reference's own f32 rounding: PyTorch's f32 SDPA lands 8.3e-6 from the
// reference there, the kernel 8.6e-6. Two choices keep the kernel's own
// share small. The CPU emulation models the tensor cores as adding each
// k8 step to the f32 accumulator with truncation (round toward zero), an
// error that scales with the running sum at that step, so (a) each product
// takes its two small correction terms first and the large hi·hi steps
// on top of them, and (b) P·V of each key tile goes into a fresh
// accumulator Ot, folded into O as O = O·alpha + Ot with an f32 FMA, so
// that O is not truncated once per k8 step over the whole key range
// (1536 steps at the layer).
//
// What bounds it on an H100: at h2o-danube-3-4b's layer shape in f32
// (B = 2, S = 8192, H = 32, KH = 8, hd = 120, causal, window 4096) the
// unmasked (q, k) pairs are 1.61e9, 4 hd FLOPs each: 7.73e11 f32 FLOPs.
// Split TF32 issues three tf32 products per f32 product: 4.69 ms at the
// 495 TFLOP/s tf32 peak (11.5 ms at the fp32 CUDA cores' 67); the
// 629 MB of q, k, v and out take 0.19 ms. So the operations bound it.
// Measured there (H100 80GB HBM3, 700 W): 7.98 ms of device time a call
// (split_kv 0.15, the attention kernel 7.83), 59 % of that bound; the
// CUDA-core kernel it replaces took 34.9 ms.
//
// Design (the traps, and what this kernel does about each):
//
// 1. tf32 wgmma reads both operands K-major only (no transpose bit). Q
//    (A of Q·K^T) and K (its B) are K-major as stored; V, as B of P·V,
//    is not. A pre-pass kernel (split_kv) reads each 64-key tile of K
//    and V once per call and writes K hi/lo and V^T hi/lo, already in
//    the swizzled K-major tile layout, into a device scratch:
//        [b][kh][key tile] -> K_hi | K_lo | Vt_hi | Vt_lo, each 64 x HD
//    floats (HD = hd padded to 64 or 128, zeros past hd and Sk), so that
//    the main kernel copies each half (64 KB at HD = 128) with one bulk
//    copy and splits nothing per block. Every query tile of a kv head
//    reads those tiles: H/KH x Sq/64 = 512 times at the layer shape;
//    splitting them there would repeat the work as often. Q·scale is
//    split once per block by its consumer threads (plain loads through
//    the strides, so q takes any layout). The pre-pass costs 0.15 ms of
//    the layer's 7.98.
// 2. P from registers. The score accumulator holds, for k8 group g,
//    columns 8g + 2(t%4) and +1 of rows r and r + 8 (frag_row/frag_col);
//    the tf32 A fragment of an m64k8 slice wants columns t%4 and t%4 + 4.
//    A sum over keys does not care about their order, so split_kv
//    permutes the keys within each group of 8 in V^T's columns (k-index
//    j holds key 2j for j < 4, key 2(j - 4) + 1 above): then the
//    accumulator's registers {s[4g], s[4g+2], s[4g+1], s[4g+3]} are the A
//    fragment as they stand. P·V is wgmma with A from registers.
// 3. Shared memory (227 KB a block). Split tiles take twice the f32
//    bytes: at HD = 128, Q hi/lo 64 KB, one 64-key tile of K hi/lo 64 KB
//    and of V^T hi/lo 64 KB: 192 KB + 1 KB for alignment and barriers,
//    one block per SM. There is no room for a second stage, so K and V
//    have a buffer and a pair of barriers each: the next tile's K lands
//    while this tile's softmax and P·V run, its V while the next Q·K^T
//    runs. One consumer warpgroup of 64 query rows (a second one would
//    need its own 64 KB of Q) and one producer warp. At HD = 64 it is
//    96 KB, two blocks per SM.
// 4. Precision margin: see above; hi rounds with RNA (tf32_rna), q·scale
//    is formed as the TPU kernel forms it, and exp(s - m) is taken as
//    exp2((s - m)·log2e), so that a row whose keys are all masked so far
//    gets exp(0) = 1 as in the TPU kernel (an FMA s·log2e - m·log2e would
//    leave the rounding of 1e30·log2e there, and overflow).
// 5. Masking: key tiles wholly outside the causal window are skipped
//    (the TPU kernel only masks them), which is exact for every query
//    row that sees a key; the wrapper refuses a row that sees none. Only
//    tiles that cross Sk, the diagonal or the window's lower edge pay for
//    the position compare.
//
// Per 64-key tile, the consumer warpgroup (128 threads, 64 query rows),
// with the cycles one block spends per tile at the layer shape
// (kernels/phase_clocks.py; H100 at 1980 MHz):
//   S  = Q K^T   48 x wgmma m64n64k8 (hi·lo, lo·hi per k8 step, then the
//                16 hi·hi), both operands from shared memory     1793
//   mask, online softmax in f32, P split into hi/lo A fragments   921
//   Ot = P V     24 x wgmma m64nHDk8 (the same order), A from
//                registers; O = O·alpha + Ot                      1693
//   waiting for V and for the next K                         121 + 149
// The products issue back to back: the SASS holds one
// WARPGROUP.DEPBAR per product group (4 in all against 120 HGMMA, both
// head-dim variants). The tensor cores idle while the softmax runs
// (about a fifth of a tile): overlapping the two needs a second consumer
// warpgroup, for which shared memory has no room at HD = 128.
// Epilogue: O / max(l, 1e-30), stored at rows < Sq and columns < hd.
//
// Host-side settings (the shared-memory attribute) are cached per device.
#include "flash_tf32.cuh"

namespace {

using namespace repro_torch;

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr int kConsumers = kWgThreads;    // one consumer warpgroup
constexpr int kThreads = kConsumers + 32; // + the producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one split half (hi or lo) of a 64 x HD tile of Q, K or V^T
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return kBQ * HD * 4;
}
// Q hi/lo, K hi/lo, V^T hi/lo, 1 KB of alignment slack, 4 barriers
template <int HD>
constexpr size_t smem_bytes() {
  return 1024 + 6 * (size_t)tile_bytes<HD>() + 4 * sizeof(uint64_t);
}
static_assert(smem_bytes<128>() <= 232448, "227 KB a block");

struct Shape {
  int Sq, Sk, H, KH, hd, kv_group, causal, window, q_offset, n_tiles;
  float scale;
  int64_t qsb, qss, qsh;         // q strides (elements)
  int64_t osb, oss, osh;         // out strides
};

// the consumer warpgroup's own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

#ifdef REPRO_PHASE_CLOCKS
// block (0, 0, 0)'s consumer thread 0: [0] start, [1] Q split, [2] first
// K landed, [3]-[7] cycles summed over tiles (Q·K^T, softmax and split,
// V wait, P·V and fold, K wait), [8] end, [9] tiles
#define FLASH_CLOCK(stmt)                                               \
  do {                                                                  \
    if (clocked) { stmt; }                                              \
  } while (0)
#else
#define FLASH_CLOCK(stmt)
#endif

// ---------------------------------------------------------- main kernel
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32(const float* __restrict__ q, const uint8_t* __restrict__ kv,
           float* __restrict__ out, const Shape sh) {
  constexpr int kTile = tile_bytes<HD>();
  constexpr int kO = HD / 2;                 // accumulator registers of O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_hi = smem_addr(smem);
  const uint32_t q_lo = q_hi + kTile;
  const uint32_t k_hi = q_hi + 2 * kTile;      // K hi | K lo
  const uint32_t k_lo = q_hi + 3 * kTile;
  const uint32_t v_hi = q_hi + 4 * kTile;      // V^T hi | V^T lo
  const uint32_t v_lo = q_hi + 5 * kTile;
  const uint32_t k_full = q_hi + 6 * kTile, k_empty = k_full + 8;
  const uint32_t v_full = k_full + 16, v_empty = k_full + 24;

  // heaviest query tiles (most keys under a causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
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
    mbar_init(k_full);
    mbar_init(v_full);
    mbar_init(k_empty, kConsumers / 32);
    mbar_init(v_empty, kConsumers / 32);
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x % 32) return;
    const uint8_t* src =
        kv + (((size_t)b * sh.KH + kh) * sh.n_tiles + t_begin) * 4 * kTile;
    for (int i = 0; i < n_tiles; ++i, src += 4 * kTile) {
      const uint32_t parity = (i & 1) ^ 1;     // the previous tile's release
      mbar_wait(k_empty, parity);
      mbar_expect_tx(k_full, 2 * kTile);
      bulk_load(k_hi, src, 2 * kTile, k_full);
      mbar_wait(v_empty, parity);
      mbar_expect_tx(v_full, 2 * kTile);
      bulk_load(v_hi, src + 2 * kTile, 2 * kTile, v_full);
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

  // Q · scale, split into hi/lo swizzled tiles (zeros past Sq and hd):
  // every load is issued before the first is used (one at a time, each
  // waiting for the last, took 27K cycles)
  {
    constexpr int kPer = kBQ * HD / kConsumers;
    const float* qb = q + b * sh.qsb + h * sh.qsh;
    float* qh = reinterpret_cast<float*>(smem);
    float* ql = reinterpret_cast<float*>(smem + kTile);
    float x[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kConsumers, r = e / HD, d = e % HD;
      x[j] = (q0 + r < sh.Sq && d < sh.hd)
                 ? qb[(int64_t)(q0 + r) * sh.qss + d]
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kConsumers;
      const float xs = x[j] * sh.scale;
      const float hi = tf32_rna(xs);
      const uint32_t off = sw128(e / HD, e % HD, kBQ) / 4;
      qh[off] = hi;
      ql[off] = tf32_rna(xs - hi);
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
  float o[kO], ot[kO], s[32];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = ot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const uint32_t parity = i & 1;
    const int k0 = (t_begin + i) * kBK;
    mbar_wait(k_full, parity);
#ifdef REPRO_PHASE_CLOCKS
    if (i == 0) FLASH_CLOCK(repro_phase_clocks[2] = clock64());
#endif
    FLASH_LAP(4);

    // S = Q K^T: the correction terms first, the hi·hi steps on top
    fence_regs(s);
    wg_fence();
    mma_ss<0>(s, desc_sw128(q_hi + kstep(0, kBQ)),
              desc_sw128(k_lo + kstep(0, kBK)));
    mma_ss<1>(s, desc_sw128(q_lo + kstep(0, kBQ)),
              desc_sw128(k_hi + kstep(0, kBK)));
#pragma unroll
    for (int kk = 1; kk < HD / 8; ++kk) {
      mma_ss<1>(s, desc_sw128(q_hi + kstep(kk, kBQ)),
                desc_sw128(k_lo + kstep(kk, kBK)));
      mma_ss<1>(s, desc_sw128(q_lo + kstep(kk, kBQ)),
                desc_sw128(k_hi + kstep(kk, kBK)));
    }
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      mma_ss<1>(s, desc_sw128(q_hi + kstep(kk, kBQ)),
                desc_sw128(k_hi + kstep(kk, kBK)));
    wg_commit();
    wg_wait0();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty);
    FLASH_LAP(0);

    // mask, online softmax (rows row0 and row0 + 8)
    const bool edge = k0 + kBK > sh.Sk ||
                      (sh.causal && k0 + kBK - 1 > qp_lo) ||
                      (sh.window > 0 && qp_hi - k0 >= sh.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
    // p = exp(s - m), split into the A fragments of the 8 k8 slices
    // (trap 2: registers 4g, 4g + 2, 4g + 1, 4g + 3 of group g)
    uint32_t p_hi[8][4], p_lo[8][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
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

    mbar_wait(v_full, parity);
    FLASH_LAP(2);
    // Ot = P V: the correction terms first, the hi·hi steps on top
    fence_regs(ot);
    wg_fence();
    mma_rs<0>(ot, p_hi[0], desc_sw128(v_lo + kstep(0, HD)));
    mma_rs<1>(ot, p_lo[0], desc_sw128(v_hi + kstep(0, HD)));
#pragma unroll
    for (int g = 1; g < 8; ++g) {
      mma_rs<1>(ot, p_hi[g], desc_sw128(v_lo + kstep(g, HD)));
      mma_rs<1>(ot, p_lo[g], desc_sw128(v_hi + kstep(g, HD)));
    }
#pragma unroll
    for (int g = 0; g < 8; ++g)
      mma_rs<1>(ot, p_hi[g], desc_sw128(v_hi + kstep(g, HD)));
    wg_commit();
    wg_wait0();
    fence_regs(ot);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty);
#pragma unroll
    for (int j = 0; j < kO; ++j)
      o[j] = fmaf(o[j], (j & 2) ? a1 : a0, ot[j]);
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
    for (int j = 0; j < HD / 8; ++j) {
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

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           uint8_t* scratch, int B, int Sq, int Sk, int H, int KH, int hd,
           const int64_t* st, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const int slot = cached_device();
  if (slot < 0 || !configured[slot]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tf32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    if (slot >= 0) configured[slot] = true;
  }
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const KVShape ks{Sk, KH, hd, n_tiles, st[3], st[4], st[5],
                   st[6], st[7], st[8]};
  split_kv<HD, kBK><<<dim3(n_tiles, KH, B), kSplitThreads, 0, stream>>>(
      k, v, scratch, ks);
  const Shape sh{Sq, Sk, H, KH, hd, H / KH, causal, window, q_offset,
                 n_tiles, scale, st[0], st[1], st[2], st[9], st[10],
                 st[11]};
  flash_tf32<HD><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads,
                   smem_bytes<HD>(), stream>>>(q, scratch, out, sh);
  return (int)cudaGetLastError();
}

// padded head dim of the tiles
int tile_hd(int hd) { return hd <= 64 ? 64 : 128; }

}  // namespace

// bytes of the K / V^T hi/lo scratch that flash_attention_tf32 needs
extern "C" long long flash_attention_tf32_scratch_bytes(int B, int Sk,
                                                         int KH, int hd) {
  const long long tiles = (long long)B * KH * ((Sk + kBK - 1) / kBK);
  return tiles * 4 * (tile_hd(hd) == 64 ? tile_bytes<64>()
                                        : tile_bytes<128>());
}

// q [B,Sq,H,hd], k/v [B,Sk,KH,hd], out [B,Sq,H,hd], f32 on the device,
// each given by its batch, sequence and head strides in elements (the
// head-dim axis contiguous); `scratch` of flash_attention_tf32_scratch_
// bytes, 16-byte aligned. hd <= 128; window 0 = none. Launches split_kv,
// then the attention kernel, on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_tf32(
    const float* q, const float* k, const float* v, float* out,
    void* scratch, int B, int Sq, int Sk, int H, int KH, int hd,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, int causal, int window, int q_offset,
    float scale, void* stream) {
  const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                          vsb, vss, vsh, osb, oss, osh};
  uint8_t* s = static_cast<uint8_t*>(scratch);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return tile_hd(hd) == 64
             ? launch<64>(q, k, v, out, s, B, Sq, Sk, H, KH, hd, st, causal,
                          window, q_offset, scale, cs)
             : launch<128>(q, k, v, out, s, B, Sq, Sk, H, KH, hd, st,
                           causal, window, q_offset, scale, cs);
}
