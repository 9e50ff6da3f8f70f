// segment_aggregate: the fused sparse GraphSAGE hop, written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/segment_aggregate/kernel.py:
// segment_aggregate_mf (body _kernel). Over one packed batch:
//
//     msg    = act((x * node_mask) @ (w * w_scale))          [M, F]
//     out[d] = sum_{e: scatter[e] = d} edge_mask[e] * msg[gather[e]]
//     mean:    out[d] /= max(sum_{e: scatter[e] = d} edge_mask[e], 1)
//
// Two entry points, one per weight type of the TPU kernel:
// segment_aggregate_f32 (f32 w, unit or real scales) and
// segment_aggregate_i8 (int8 w with per-channel f32 scales: the int8
// serving path, where w crosses device memory as int8). Both are one
// template.
//
// What bounds it on an H100: at the replay stream's packs (M = 32..512
// nodes, D = F = 192) the work is at most ~40 MFLOP and ~1 MB, so one
// block's chain (stage, split, product, walk) and the launch bound it. A
// whole program segmented at a budget of 512 gives one inner batch of
// ~10-16k row slots: ~0.74 GFLOP for its real rows over ~25 MB. The
// products are f32-accurate split-TF32 on the tensor cores (tf32_mma.cuh:
// three tf32 products per f32 product, so 165 TFLOP/s of counted work at
// most), so at that size memory bounds it (7.6 us against 4.5 us of
// products). The TPU kernel's one-hot matmuls for the gather and scatter,
// and its x8/x128 padding, are MXU idioms and are not carried over.
//
// Design. A block of two warpgroups owns a 64-channel F-tile. Per 64-row
// tile it stages its x rows and, once, the F-tile of w (each depth chunk
// in one go: TMA where the layout allows, cp.async otherwise), splits w
// as it transposes it into a K-major tile (dequantizing w · scale on the
// way: the int8 variant is the second instantiation of the template; w
// crosses device memory as int8), splits x · node_mask in place, and one
// warpgroup issues the products (wgmma m64n64k8 tf32). A row
// tile whose node_mask is all zero skips the product: its messages are
// act(0) = 0.
//   Fused (M <= 512, at most 8 row tiles; the caller passes no scratch):
//     one block per row tile, and the row tiles of one F-tile form a
//     thread-block cluster. The tile's CSR rows and edges are staged
//     beside its operands. Each block keeps its message tile in shared
//     memory; after a cluster barrier, four threads per destination (16
//     channels each) walk that destination's edges in CSR order and read
//     each source row from the shared memory of the block that owns it
//     (distributed shared memory). One launch.
//   Two launches (larger M): a persistent grid, one block per SM, each
//     walking row tiles with its F-tile of w staged and split once; the
//     transform writes msg to a device scratch [M, F] (L2-resident at the
//     serving sizes) and aggregate_kernel walks the CSR, one warp per
//     destination over all of F.
// The CSR (edges sorted stably by destination, built once per batch and
// direction by the wrapper, masked padding edges left out) gives each
// output one writer: no atomics, the sum order is fixed, and integer-
// valued inputs give exact results.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace repro_torch;

constexpr int kThreads = 2 * kWgThreads;
constexpr int kWarps = kThreads / 32;       // destinations per block
constexpr int kChanPerLane = 8;             // aggregate_kernel: 256 / 32
constexpr int kMaxClusterTiles = 8;         // fused: M <= 8 x 64 = 512
constexpr int kMsgStride = 72;              // fused message tile row (floats)
constexpr int kEdgeCap = 2048;              // fused: a tile's edges staged
constexpr int kSlotBytes = kTileRows * kMsgStride * 4;   // one message tile

struct Params {
  const float* x;
  const void* w;
  const float* scale;
  const float* node_mask;
  const int* rowptr;
  const int* src;
  const float* ew;
  float* msg;            // two launches: [M, F] scratch; fused: unused
  float* out;
  int M, D, F, KC, relu, mean;
  int x_tma, w_tma;      // stage x / w through TMA (tm_x, tm_w)
  int out_vec;           // F % 4 == 0 and out 16-byte aligned
};

// shared memory: x hi, x lo (raw w while staging), w hi, w lo (each 64 x
// KC floats; fused: the message tile over them); node_mask, scale and
// rowptr of the tile (64, 64, 65 + 3); the tile's edges (fused: kEdgeCap
// sources and weights); the mbarrier
__host__ __device__ inline int staging_bytes(int KC) {
  const int tiles = 4 * kTileRows * KC * 4;
  return tiles > kSlotBytes ? tiles : kSlotBytes;
}
__host__ __device__ inline size_t smem_bytes(int KC) {
  return 1024 + (size_t)staging_bytes(KC) + (64 + 64 + 68) * 4 +
         2 * kEdgeCap * 4 + 16;
}

// One block per (64-row tile, 64-channel F-tile), or, in the two-launch
// plan, a persistent block per (row-tile slot, F-tile) that walks row
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... and stages and splits its
// F-tile of w once (when one depth chunk covers D).
template <typename WT, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
segment_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tile_bytes = kTileRows * p.KC * 4;
  float* x_hi = reinterpret_cast<float*>(smem);
  float* x_lo = reinterpret_cast<float*>(smem + tile_bytes);
  float* w_hi = reinterpret_cast<float*>(smem + 2 * tile_bytes);
  float* w_lo = reinterpret_cast<float*>(smem + 3 * tile_bytes);
  float* nm_s = reinterpret_cast<float*>(smem + staging_bytes(p.KC));
  float* scale_s = nm_s + 64;
  int* rowptr_s = reinterpret_cast<int*>(scale_s + 64);
  int* esrc_s = rowptr_s + 68;
  float* ew_s = reinterpret_cast<float*>(esrc_s + kEdgeCap);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ew_s + kEdgeCap);
  WT* w_raw = reinterpret_cast<WT*>(x_lo);
  Stage st{smem_addr(bar), 0};

  const int f0 = blockIdx.y * 64;
  const int fv = min(64, p.F - f0);
  const int tid = threadIdx.x;
  const int wg = wg_index();
  const int tiles = (p.M + kTileRows - 1) / kTileRows;
  const int chunks = (p.D + p.KC - 1) / p.KC;
  const WT* w = static_cast<const WT*>(p.w);
  if (tid == 0) mbar_init(st.bar);
  __syncthreads();
  bool w_ready = false;     // w hi/lo hold the whole depth

  // issue the loads of depth chunk c of row tile r0 (w too until it is
  // held whole); returns whether they include TMA boxes
  const auto issue = [&](int c, int r0, int rows) -> bool {
    const int k0 = c * p.KC, kv = min(p.KC, p.D - k0);
    const bool w_tma = !w_ready && p.w_tma;
    stage_begin(st, (p.x_tma ? tile_bytes : 0) +
                        (w_tma ? p.KC * 64 * (int)sizeof(WT) : 0));
    if (p.x_tma)
      tma_rows(st, smem_addr(x_hi), &tm_x, k0, r0, 0, p.KC);
    else
      stage_rows(smem_addr(x_hi), p.x + (size_t)r0 * p.D + k0, p.D, rows,
                 kv, p.KC);
    if (w_tma)
      tma_box(st, smem_addr(w_raw), &tm_w, f0, k0, 0);
    else if (!w_ready)
      stage_w_raw<WT>(w_raw, w + (size_t)k0 * p.F + f0, p.F, kv, fv, p.KC);
    return p.x_tma || w_tma;
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * kTileRows;
    const int rows = min(kTileRows, p.M - r0);
    REPRO_PHASE(0);
    // fused: the first chunk's loads go out before the tile's node_mask
    // is known (a pack's tile is rarely all padding); the two-launch plan,
    // where whole tiles of padding are common, waits for it
    const bool early = kFused && chunks > 0;
    const bool early_tma = early && issue(0, r0, rows);
    if (tid < 64) nm_s[tid] = tid < rows ? p.node_mask[r0 + tid] : 0.f;
    if (tid < 64) scale_s[tid] = tid < fv ? p.scale[f0 + tid] : 0.f;
    if (kFused && tid <= rows) rowptr_s[tid] = p.rowptr[r0 + tid];
    const bool any_row = __syncthreads_or(tid < 64 && nm_s[tid] != 0.f);
    int e_base = 0;
    if constexpr (kFused) {   // the tile's edges, beside the operands
      e_base = rowptr_s[0];
      const int n = min(rowptr_s[rows] - e_base, kEdgeCap);
      for (int i = tid; i < n; i += kThreads) {
        cp_async4(smem_addr(esrc_s + i), p.src + e_base + i, 4);
        cp_async4(smem_addr(ew_s + i), p.ew + e_base + i, 4);
      }
    }
    if (early && !any_row) stage_end(st, early_tma);   // unused, but landed

    float acc[32];            // warpgroup 0: the tile's 64 x 64 products
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int c = 0; any_row && c < chunks; ++c) {
      const bool stage_w = !w_ready;
      const bool tma = (early && c == 0) ? early_tma : issue(c, r0, rows);
      REPRO_PHASE(1);
      stage_end(st, tma);
      REPRO_PHASE(2);
      if (stage_w) {
        split_w<WT>(w_raw, w_hi, w_lo, p.KC, scale_s);
        __syncthreads();                     // raw w read: x lo is free
        w_ready = chunks == 1;
      }
      REPRO_PHASE(3);
      split_tile(x_hi, x_lo, tile_bytes, nm_s);
      fence_proxy_async();
      __syncthreads();
      REPRO_PHASE(4);
      if (product_warpgroup())
        split_product(acc, smem_addr(x_hi), smem_addr(x_lo), smem_addr(w_hi),
                      smem_addr(w_lo), p.KC);
      __syncthreads();                       // tiles are rewritten next
      REPRO_PHASE(5);
    }
    if (p.relu) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaxf(acc[i], 0.f);
    }

    if constexpr (!kFused) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = frag_row(i), c = frag_col(i);
        if (wg == 0 && r < rows && c < fv)
          p.msg[(size_t)(r0 + r) * p.F + f0 + c] = acc[i];
      }
    } else {
      // the message tile [64][kMsgStride] over the (now free) staging tiles
      float* msg_s = x_hi;
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          msg_s[frag_row(i) * kMsgStride + frag_col(i)] = acc[i];
      }
      cp_async_wait_all();                   // the edges (no product ran)
      REPRO_PHASE(6);
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      REPRO_PHASE(7);
      // 4 threads per destination in CSR order, thread q taking channels
      // 16 j + 4 q .. 16 j + 4 q + 3 (j < 4), so that the 4 threads read
      // and write 64 contiguous bytes at a time; each source row is read
      // from the shared memory of the block that owns it (its own tile
      // locally)
      const int r = tid / 4, q = tid % 4;
      const uint32_t msg_addr = smem_addr(msg_s) + 16 * q;
      float a[16] = {};
      float deg = 0.f;
      if (r < rows) {
        for (int e = rowptr_s[r]; e < rowptr_s[r + 1]; ++e) {
          const bool staged = e - e_base < kEdgeCap;
          const int s = staged ? esrc_s[e - e_base] : p.src[e];
          const float we = staged ? ew_s[e - e_base] : p.ew[e];
          const uint32_t row = msg_addr + (s % kTileRows) * kMsgStride * 4;
          float4 v[4];
          if (s / kTileRows == t) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = ld_smem4(row + 64 * j);
          } else {
            const uint32_t remote = dsmem_addr(row, s / kTileRows);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = ld_dsmem4(remote + 64 * j);
          }
          deg += we;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[4 * j] += we * v[j].x;
            a[4 * j + 1] += we * v[j].y;
            a[4 * j + 2] += we * v[j].z;
            a[4 * j + 3] += we * v[j].w;
          }
        }
        if (p.mean) {
          const float den = fmaxf(deg, 1.f), inv = 1.f / den;
#pragma unroll
          for (int j = 0; j < 16; ++j) a[j] = div_by(a[j], den, inv);
        }
      }
      REPRO_PHASE(10);
      if (r < rows) {
        float* o = p.out + (size_t)(r0 + r) * p.F + f0 + 4 * q;
#pragma unroll
        for (int j = 0; j < 4; ++j) {        // 16-byte stores where aligned
          const int c = 16 * j + 4 * q;      // the first channel of a[4 j]
          if (p.out_vec && c + 3 < fv) {
            *reinterpret_cast<float4*>(o + 16 * j) = make_float4(
                a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]);
          } else {
            for (int u = 0; u < 4; ++u)
              if (c + u < fv) o[16 * j + u] = a[4 * j + u];
          }
        }
      }
      REPRO_PHASE(8);
      cluster.sync();         // the other blocks read this block's tile
      REPRO_PHASE(9);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float* __restrict__ msg,
                 const int* __restrict__ rowptr, const int* __restrict__ src,
                 const float* __restrict__ ew, float* __restrict__ out,
                 int M, int F, int mean) {
  const int lane = threadIdx.x % 32;
  const int d = blockIdx.x * kWarps + threadIdx.x / 32;
  if (d >= M) return;
  const int e0 = rowptr[d], e1 = rowptr[d + 1];
  float deg = 0.f;
  for (int e = e0; e < e1; ++e) deg += ew[e];
  const float den = fmaxf(deg, 1.f), inv = 1.f / den;
  for (int c0 = 0; c0 < F; c0 += 32 * kChanPerLane) {
    float acc[kChanPerLane];
#pragma unroll
    for (int t = 0; t < kChanPerLane; ++t) acc[t] = 0.f;
    for (int e = e0; e < e1; ++e) {
      const float* row = msg + (size_t)src[e] * F;
      const float we = ew[e];
#pragma unroll
      for (int t = 0; t < kChanPerLane; ++t) {
        const int f = c0 + lane + 32 * t;
        if (f < F) acc[t] += we * row[f];
      }
    }
#pragma unroll
    for (int t = 0; t < kChanPerLane; ++t) {
      const int f = c0 + lane + 32 * t;
      if (f < F)
        out[(size_t)d * F + f] = mean ? div_by(acc[t], den, inv) : acc[t];
    }
  }
}

constexpr int kErrNoScratch = 30000;   // two-launch plan without scratch

// raises the kernel's shared-memory limit on the current device, once
template <typename WT, bool kFused>
int set_smem_limit() {
  static bool done[kMaxDevices] = {};
  const int slot = cached_device();
  if (slot >= 0 && done[slot]) return 0;
  const int err = (int)cudaFuncSetAttribute(
      segment_kernel<WT, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxKC));
  if (!err && slot >= 0) done[slot] = true;
  return err;
}

template <typename WT>
int launch(const float* x, const WT* w, const float* scale,
           const float* node_mask, const int* rowptr, const int* src,
           const float* ew, float* msg, float* out, int M, int D, int F,
           int relu, int mean, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (M + kTileRows - 1) / kTileRows;
  const bool fused = msg == nullptr;
  if (M == 0 || F == 0) return 0;
  if (fused && tiles > kMaxClusterTiles) return kErrNoScratch;
  const int KC = chunk_cols(D, kMaxKC);
  constexpr int kE = (int)sizeof(WT);
  Params p{x, w, scale, node_mask, rowptr, src, ew, msg, out, M, D, F, KC,
           relu, mean, tma_ok(x, D, 4), tma_ok(w, F, kE), tma_ok(out, F, 4)};
  // x: 32 columns x 64 rows a box, swizzled as the tiles are; w: the
  // block's raw [KC][64] block in one box
  CUtensorMap tm_x = {}, tm_w = {};
  int err = 0;
  if (p.x_tma)
    err = encode_3d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, M, 1,
                    32, kTileRows, true);
  if (!err && p.w_tma)
    err = encode_3d(&tm_w, w,
                    kE == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    kE, F, D, 1, 64, KC, false);
  if (err) return err;
  const int f_tiles = (F + 63) / 64;
  const size_t smem = smem_bytes(KC);
  if (fused) {
    err = set_smem_limit<WT, true>();
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles, f_tiles);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = tiles;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, segment_kernel<WT, true>, tm_x,
                                   tm_w, p);
  }
  err = set_smem_limit<WT, false>();
  if (err) return err;
  // one block per SM, each walking row tiles with its F-tile of w staged
  const int slots = min(tiles, max(1, sm_count() / f_tiles));
  segment_kernel<WT, false><<<dim3(slots, f_tiles), kThreads, smem, s>>>(
      tm_x, tm_w, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  aggregate_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      msg, rowptr, src, ew, out, M, F, mean);
  return (int)cudaGetLastError();
}

}  // namespace

// Row tiles of 64 that one fused launch (a thread-block cluster) covers:
// a call with M <= 64 * this passes no scratch (msg = NULL).
extern "C" int segment_aggregate_fused_max_rows() {
  return kTileRows * kMaxClusterTiles;
}

// x [M,D], w [D,F] (float32 or int8), scale [F], node_mask [M],
// rowptr [M+1], src/ew [E] (CSR by destination), out [M,F]: contiguous,
// on the device. msg: NULL for the fused launch (M <= fused_max_rows),
// else an [M,F] f32 scratch for the two-launch plan. Launch on `stream`;
// return 0, a CUDA error, 30000 (M too large for the fused launch), 10000
// (no tensor-map encoder) or 20000 + the encoder's CUresult.
extern "C" int segment_aggregate_f32(const float* x, const float* w,
                                     const float* scale,
                                     const float* node_mask,
                                     const int* rowptr, const int* src,
                                     const float* ew, float* msg, float* out,
                                     int M, int D, int F, int relu, int mean,
                                     void* stream) {
  return launch<float>(x, w, scale, node_mask, rowptr, src, ew, msg, out,
                       M, D, F, relu, mean, stream);
}

// The int8-weight variant: w is int8 and is dequantised (w * scale[f])
// as the block splits it into shared memory, so it crosses device memory
// at a quarter of the f32 bytes.
extern "C" int segment_aggregate_i8(const float* x, const int8_t* w,
                                    const float* scale,
                                    const float* node_mask,
                                    const int* rowptr, const int* src,
                                    const float* ew, float* msg, float* out,
                                    int M, int D, int F, int relu, int mean,
                                    void* stream) {
  return launch<int8_t>(x, w, scale, node_mask, rowptr, src, ew, msg, out,
                        M, D, F, relu, mean, stream);
}
