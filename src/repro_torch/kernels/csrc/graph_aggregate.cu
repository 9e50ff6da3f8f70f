// graph_aggregate: the fused dense GraphSAGE hop, written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/graph_aggregate/kernel.py:
// graph_aggregate_bnd (body _kernel). Per graph b of the batch:
//
//     out[b] = A[b] @ act(X[b] @ W)      A [N, N], X [N, D], W [D, F]
//     mean: out[b][i] /= max(sum_j A[b][i][j], 1)
//
// What bounds it on an H100: at the serving shape (B = 128 graphs,
// N = 64 nodes, D = F = 192) the call moves ~15 MB and counts ~0.8 GFLOP.
// The products are f32-accurate split-TF32 on the tensor cores
// (tf32_mma.cuh: three tf32 products per f32 product, two for the 0/1
// adjacency), so the least time is the larger of 15 MB at 3.35 TB/s and
// 0.8 GFLOP at 165 TFLOP/s: 4.9 us, the operations. A block's chain of
// latencies (stage, split, product, split, product) comes on top; at
// that shape the message tensor act(X W) never leaves the SM.
//
// Design: a persistent grid of two-warpgroup blocks, one per SM: a block
// owns an F-tile of 64 channels, stages and splits W's tile once, and
// walks graphs b = blockIdx.y, blockIdx.y + gridDim.y, ...
//   1. msg = act(X[b] @ W[:, tile]): for each 64-row tile of nodes, the
//      block stages X's rows (TMA where the layout allows, else cp.async;
//      W's tile the same way, once, when one depth chunk covers D),
//      splits W as it transposes it into a K-major tile and X in place,
//      and each warpgroup takes 32 channels with wgmma m64n32k8 tf32 (no
//      branch around the products: see tf32_mma.cuh).
//      The accumulators, split, go to shared memory as msg^T (rows =
//      channels, K = source node): the B operand of the second product.
//   2. out = A[b] @ msg: for each 64-row tile of destinations, the block
//      stages A's rows (K = source node), takes their row sums (for mean)
//      and splits A in place; the product takes the three terms (for a
//      0/1 adjacency, whose lo half is 0, the third adds exact zeros).
// Ragged N, D and F are zero-filled at the loads and masked at the
// stores; N = 17 rows of A are 68 bytes, which neither TMA nor 16-byte
// copies take, so they travel as 4-byte copies. Nodes are padded to
// 64-row tiles (N <= 64: one tile; N = 100: two).
//
// Large graphs. msg^T hi and lo take 512 bytes per padded node, and A's
// staged rows as much again, so shared memory holds them up to N = 192
// (at D = 192). Beyond that the block keeps msg^T, split, in its own slice
// of a device scratch (graph_aggregate_scratch_bytes) and walks step 2 in
// chunks of kScratchKA source nodes: A's chunk staged and split, msg^T's
// chunk copied in, products summed in the same accumulators. The scratch
// has the tile's layout, so a chunk is a straight 16-byte copy. N is then
// bounded by nothing but device memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 2 * kWgThreads;
constexpr int kSmemLimit = 232448;          // sm_90 opt-in per block
constexpr int kScratchKA = 64;              // source nodes per chunk

struct Layout {
  int NP, KC, KA;        // KA: source nodes of one chunk of A·msg
  bool scratch;          // msg^T in a device scratch (else all in the SM)
  size_t stage, bytes;   // stage: bytes of each of the two staging tiles
};

// shared memory: X hi | X lo (raw W while staging) — A hi | A lo in step 2
// (each 64 x max(KC, KA) floats), W hi, W lo (64 x KC), msg^T hi, lo
// (64 x KA: all of it, or the chunk copied from the scratch), the row
// sums of one tile (64 floats)
__host__ __device__ inline Layout layout_for(int N, int D, int max_kc,
                                             bool scratch) {
  Layout L;
  L.NP = round_up(N > 0 ? N : 1, kTileRows);
  L.KC = chunk_cols(D, max_kc);
  L.KA = scratch ? kScratchKA : L.NP;
  L.scratch = scratch;
  L.stage = (size_t)kTileRows * (L.KC > L.KA ? L.KC : L.KA) * 4;
  L.bytes = 1024 + 2 * L.stage + 2 * (size_t)kTileRows * L.KC * 4 +
            2 * (size_t)kTileRows * L.KA * 4 + 64 * 4 + 16;
  return L;
}

// msg^T in the SM where it fits, else in the scratch; the widest depth
// chunk that fits either way (the scratch plan fits at any N)
__host__ __device__ inline Layout layout(int N, int D) {
  for (int scratch = 0; scratch < 2; ++scratch)
    for (int kc = kMaxKC; kc >= 32; kc -= 32) {
      const Layout L = layout_for(N, D, kc, scratch);
      if (L.bytes <= kSmemLimit) return L;
    }
  return layout_for(N, D, 32, true);
}

struct Params {
  const float* adj;
  const float* x;
  const float* w;
  float* out;
  float* scratch;       // 2 x 64 x NP floats per block, or null
  int B, N, D, F, NP, KC, KA, relu, mean;
  int stage, f_even;    // f_even: F even and out 8-byte aligned
  int x_tma, w_tma, a_tma;  // stage X / W / A through TMA
};

template <bool kScratch>
__global__ void __launch_bounds__(kThreads, 1)
graph_aggregate_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_a,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kc_bytes = kTileRows * p.KC * 4;
  const int ka_bytes = kTileRows * p.KA * 4;
  float* s_hi = reinterpret_cast<float*>(smem);            // X, then A
  float* s_lo = reinterpret_cast<float*>(smem + p.stage);
  float* w_hi = reinterpret_cast<float*>(smem + 2 * p.stage);
  float* w_lo = reinterpret_cast<float*>(smem + 2 * p.stage + kc_bytes);
  uint8_t* m_hi = smem + 2 * p.stage + 2 * kc_bytes;      // msg^T
  uint8_t* m_lo = m_hi + ka_bytes;
  float* deg_s = reinterpret_cast<float*>(m_lo + ka_bytes);
  Stage st{smem_addr(deg_s + 64), 0};
  // where step 1 keeps msg^T: this block's slice of the scratch, or the SM
  uint8_t* g_hi = m_hi;
  if (kScratch)
    g_hi = reinterpret_cast<uint8_t*>(
        p.scratch +
        (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 2 * kTileRows * p.NP);
  uint8_t* g_lo = kScratch ? g_hi + (size_t)kTileRows * p.NP * 4 : m_lo;

  const int f0 = blockIdx.x * 64;
  const int fv = min(64, p.F - f0);
  const int tid = threadIdx.x;
  const int wg = wg_index();
  const int chunks = (p.D + p.KC - 1) / p.KC;
  bool w_ready = false;     // W hi/lo hold the whole depth
  if (tid == 0) mbar_init(st.bar);
  __syncthreads();

  for (int b = blockIdx.y; b < p.B; b += gridDim.y) {
    const float* xb = p.x + (size_t)b * p.N * p.D;
    const float* ab = p.adj + (size_t)b * p.N * p.N;
    REPRO_PHASE(0);
    // 1: msg^T = act(X[b] @ W[:, tile])^T, split, into shared memory
    for (int t0 = 0; t0 < p.NP; t0 += kTileRows) {
      const int rows = min(kTileRows, p.N - t0);
      float acc[16];          // this warpgroup's 32 channels
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const int k0 = c * p.KC, kv = min(p.KC, p.D - k0);
        const bool stage_w = !w_ready;
        const bool w_tma = stage_w && p.w_tma;
        stage_begin(st, (p.x_tma ? kc_bytes : 0) + (w_tma ? kc_bytes : 0));
        if (p.x_tma)
          tma_rows(st, smem_addr(s_hi), &tm_x, k0, t0, b, p.KC);
        else
          stage_rows(smem_addr(s_hi), xb + (size_t)t0 * p.D + k0, p.D, rows,
                     kv, p.KC);
        if (w_tma)
          tma_box(st, smem_addr(s_lo), &tm_w, f0, k0, 0);
        else if (stage_w)
          stage_w_raw<float>(s_lo, p.w + (size_t)k0 * p.F + f0, p.F, kv, fv,
                             p.KC);
        REPRO_PHASE(1);
        stage_end(st, p.x_tma || w_tma);
        REPRO_PHASE(2);
        if (stage_w) {
          split_w<float>(s_lo, w_hi, w_lo, p.KC, nullptr);
          __syncthreads();                   // raw W read: X lo is free
          w_ready = chunks == 1;
        }
        REPRO_PHASE(3);
        split_tile(s_hi, s_lo, kc_bytes, nullptr);
        fence_proxy_async();
        __syncthreads();
        REPRO_PHASE(4);
        split_product(acc, smem_addr(s_hi), smem_addr(s_lo),
                      smem_addr(w_hi) + wg * 32 * 128,
                      smem_addr(w_lo) + wg * 32 * 128, p.KC);
        __syncthreads();                     // the tiles are rewritten next
        REPRO_PHASE(5);
      }
      // rows >= N and channels >= F are 0 (zero-filled operands)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float v = p.relu ? fmaxf(acc[i], 0.f) : acc[i];
        const float h = tf32_rna(v);
        const uint32_t off =
            sw128(32 * wg + frag_col(i), t0 + frag_row(i), kTileRows);
        *reinterpret_cast<float*>(g_hi + off) = h;
        *reinterpret_cast<float*>(g_lo + off) = tf32_rna(v - h);
      }
    }
    if (kScratch) __syncthreads();   // msg^T written before it is copied

    REPRO_PHASE(6);
    // 2: out[b][tile rows, channels] = A[b] @ msg, over chunks of KA
    // source nodes (one chunk, all of them, when msg^T is in the SM)
    for (int t0 = 0; t0 < p.NP; t0 += kTileRows) {
      const int rows = min(kTileRows, p.N - t0);
      const int sr = tid / 4, sq = tid % 4;   // row sums: 4 threads a row
      float sum = 0.f;
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < p.NP; k0 += p.KA) {
        stage_begin(st, p.a_tma ? ka_bytes : 0);
        if (p.a_tma)
          tma_rows(st, smem_addr(s_hi), &tm_a, k0, t0, b, p.KA);
        else
          stage_rows(smem_addr(s_hi), ab + (size_t)t0 * p.N + k0, p.N, rows,
                     p.N - k0, p.KA);
        if (kScratch) {   // the chunk's slabs of msg^T, hi and lo
          const size_t src = (size_t)(k0 / 32) * kSlabBytes;
          for (int i = tid * 16; i < ka_bytes; i += kThreads * 16) {
            cp_async16(smem_addr(m_hi + i), g_hi + src + i);
            cp_async16(smem_addr(m_lo + i), g_lo + src + i);
          }
        }
        stage_end(st, p.a_tma);
        {   // this thread's quarter of the chunk's columns
          const int span = p.KA / 4;
          const uint8_t* a = reinterpret_cast<const uint8_t*>(s_hi);
          for (int k = sq * span; k < (sq + 1) * span; ++k)
            sum += *reinterpret_cast<const float*>(a +
                                                   sw128(sr, k, kTileRows));
          if (k0 + p.KA >= p.NP) {
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (sq == 0) deg_s[sr] = sum;
          }
        }
        __syncthreads();
        split_tile(s_hi, s_lo, ka_bytes, nullptr);
        fence_proxy_async();
        __syncthreads();
        REPRO_PHASE(7);
        // three terms: a 0/1 adjacency has no lo half, and its third term
        // adds exact zeros (a branch to skip it made the compiler
        // serialize the products)
        split_product(acc, smem_addr(s_hi), smem_addr(s_lo),
                      smem_addr(m_hi) + wg * 32 * 128,
                      smem_addr(m_lo) + wg * 32 * 128, p.KA);
        if (kScratch) __syncthreads();   // the chunk is rewritten next
      }
      REPRO_PHASE(8);
      if (p.mean) {   // rows frag_row(0) and frag_row(0) + 8
        const float d0 = fmaxf(deg_s[frag_row(0)], 1.f), i0 = 1.f / d0;
        const float d8 = fmaxf(deg_s[frag_row(2)], 1.f), i8 = 1.f / d8;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[i] = (i & 2) ? div_by(acc[i], d8, i8) : div_by(acc[i], d0, i0);
      }
      REPRO_PHASE(10);
      // pairs of neighbouring channels (i, i + 1) as one 8-byte store
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = frag_row(i), c = 32 * wg + frag_col(i);
        if (r >= rows) continue;
        float* o = p.out + ((size_t)b * p.N + t0 + r) * p.F + f0 + c;
        if (p.f_even && c + 1 < fv) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
        } else {
          if (c < fv) o[0] = acc[i];
          if (c + 1 < fv) o[1] = acc[i + 1];
        }
      }
      REPRO_PHASE(11);
      __syncthreads();           // A and the row sums are rewritten next
    }
  }
  REPRO_PHASE(9);
}

// one block per SM, each walking graphs with its F-tile of W staged
dim3 grid_for(int B, int F) {
  const int f_tiles = (F + 63) / 64;
  return dim3(f_tiles, min(B, max(1, sm_count() / f_tiles)));
}

// raises the kernel's shared-memory limit on the current device to `bytes`
template <bool kScratch>
int set_smem_limit(size_t bytes) {
  static size_t configured[kMaxDevices] = {};
  const int slot = cached_device();
  if (slot >= 0 && bytes <= configured[slot]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      graph_aggregate_kernel<kScratch>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && slot >= 0) configured[slot] = bytes;
  return (int)err;
}

}  // namespace

// Shared memory the kernel takes for N nodes and depth D (at most the
// card's opt-in limit, at any N).
extern "C" int graph_aggregate_smem_bytes(int N, int D) {
  return (int)layout(N, D).bytes;
}

// Bytes of device scratch a call needs on the current device: 0 where
// msg^T stays in the SM, else 2 x 64 x NP floats for each block.
extern "C" long long graph_aggregate_scratch_bytes(int B, int N, int D,
                                                   int F) {
  const Layout L = layout(N, D);
  if (!L.scratch || B == 0 || F == 0) return 0;
  const dim3 g = grid_for(B, F);
  return (long long)g.x * g.y * 2 * kTileRows * L.NP * 4;
}

// adj [B,N,N], x [B,N,D], w [D,F], out [B,N,F]: contiguous fp32 on the
// device; scratch: graph_aggregate_scratch_bytes(B, N, D, F) bytes on the
// device (null where that is 0). Launches on `stream`; returns 0, a CUDA
// error, 10000 (no tensor-map encoder), 20000 + the encoder's CUresult or
// 30000 (no scratch where the call needs one).
extern "C" int graph_aggregate_f32(const float* adj, const float* x,
                                   const float* w, float* out,
                                   float* scratch, int B, int N, int D,
                                   int F, int relu, int mean, void* stream) {
  if (B == 0 || N == 0 || F == 0) return 0;
  const Layout L = layout(N, D);
  if (L.scratch && !scratch) return 30000;
  const int err_smem = L.scratch ? set_smem_limit<true>(L.bytes)
                                 : set_smem_limit<false>(L.bytes);
  if (err_smem) return err_smem;
  const Params p{adj, x, w, out, scratch, B, N, D, F, L.NP, L.KC, L.KA,
                 relu, mean, (int)L.stage,
                 F % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0,
                 tma_ok(x, D, 4), tma_ok(w, F, 4), tma_ok(adj, N, 4)};
  // X and A: 32 columns x 64 rows of one graph a box, swizzled as the
  // tiles are (rows past N arrive as 0); W: the raw [KC][64] block
  CUtensorMap tm_x = {}, tm_w = {}, tm_a = {};
  int err = 0;
  if (p.x_tma)
    err = encode_3d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, N, B,
                    32, kTileRows, true);
  if (!err && p.w_tma)
    err = encode_3d(&tm_w, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, F, D, 1,
                    64, L.KC, false);
  if (!err && p.a_tma)
    err = encode_3d(&tm_a, adj, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, N, B,
                    32, kTileRows, true);
  if (err) return err;
  const dim3 grid = grid_for(B, F);
  if (L.scratch)
    graph_aggregate_kernel<true>
        <<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(tm_x, tm_w, tm_a,
                                                            p);
  else
    graph_aggregate_kernel<false>
        <<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(tm_x, tm_w, tm_a,
                                                            p);
  return (int)cudaGetLastError();
}
