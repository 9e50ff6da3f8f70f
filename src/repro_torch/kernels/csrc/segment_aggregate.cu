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
// serving path, where w crosses device memory as int8).
//
// What bounds it on an H100: at the replay stream's packs (M = 32..512
// nodes, D = F = 192) the work is at most ~40 MFLOP and ~1 MB, a few
// microseconds of the card even at the fp32 CUDA-core rate, so the
// launch itself and the dependent gathers bound it. A whole program
// segmented at a budget of 512 gives one inner batch of ~10-16k nodes:
// ~0.7 GFLOP of fp32 multiply-adds (about 0.011 ms at 67 TFLOP/s) over
// ~25 MB, so the fp32 operations bound it there. The activations are
// f32, so the product is f32 even for int8 weights. The TPU kernel's
// one-hot matmuls for the gather and scatter, and its x8/x128 padding,
// are MXU idioms and are not carried over.
//
// Design: two launches on one stream.
//   1. transform: msg = act((x * nm) @ (w * scale)) into a device scratch
//      [M, F] (384 KB at M = 512, F = 192, so it stays in the 50 MB L2),
//      one block per (F-tile of 64, 16 rows), with the shared
//      register-tile product (row_tile.cuh). The weight is dequantised
//      (w * scale) as it is staged, so the int8 variant is a second
//      instantiation of the same template.
//   2. aggregate: one warp per destination walks that destination's edges
//      in CSR order (edges sorted stably by scatter, built once per batch
//      and direction by the wrapper, with the masked padding edges left
//      out: they all point at node 0 and would serialise its warp) and
//      keeps up to 256 channels in registers. Each output is written
//      once by one warp: no atomics, so the sum order is fixed and
//      integer-valued inputs give exact results.
#include <cuda_runtime.h>
#include <cstdint>

#include "row_tile.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = kThreads / 32;   // destinations per block
constexpr int kChanPerLane = 8;         // channels a lane keeps: 256 / 32

// One row per thread: at the serving sizes (M <= 512) the blocks do not
// fill the card, and the time goes with the work of one block.
constexpr int kTM = 1;                            // rows per thread
constexpr int kKT = 16;                           // depth chunk
using Tile = RowTile<kTM, kKT>;
constexpr int kRows = Tile::kRows;                // 16 rows per block

template <typename WT>
__global__ void __launch_bounds__(kThreads)
transform_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ node_mask,
                 float* __restrict__ msg, int M, int D, int F, int relu) {
  __shared__ __align__(16) float rhs_s[Tile::kRhsFloats];
  __shared__ float lhs_s[Tile::kLhsFloats];
  const int f0 = blockIdx.x * kFT;
  const int r0 = blockIdx.y * kRows;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  float acc[kTM][kTN] = {};
  tile_product<kTM, kKT>(
      acc, lhs_s, rhs_s, r0, D,
      [&](int r, int k) {
        return (r < M && k < D) ? x[(size_t)r * D + k] * node_mask[r] : 0.f;
      },
      [&](int k, int c) {
        const int f = f0 + c;
        return (k < D && f < F)
                   ? static_cast<float>(w[(size_t)k * F + f]) * scale[f]
                   : 0.f;
      });
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty + kTY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int f = f0 + tx * kTN + j;
      if (f < F) msg[(size_t)r * F + f] = relu ? fmaxf(acc[i][j], 0.f)
                                                : acc[i][j];
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
  const float den = fmaxf(deg, 1.f);
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
      if (f < F) out[(size_t)d * F + f] = mean ? acc[t] / den : acc[t];
    }
  }
}

template <typename WT>
int launch(const float* x, const WT* w, const float* scale,
           const float* node_mask, const int* rowptr, const int* src,
           const float* ew, float* msg, float* out, int M, int D, int F,
           int relu, int mean, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tgrid((F + kFT - 1) / kFT, (M + kRows - 1) / kRows);
  transform_kernel<WT><<<tgrid, kThreads, 0, s>>>(x, w, scale, node_mask,
                                                   msg, M, D, F, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  aggregate_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      msg, rowptr, src, ew, out, M, F, mean);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M,D], w [D,F] (float32 or int8), scale [F], node_mask [M],
// rowptr [M+1], src/ew [E] (CSR by destination), msg scratch and out
// [M,F]: contiguous, on the device. Launch both phases on `stream`;
// return cudaGetLastError().
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
// as the transform stages it into shared memory, so it crosses device
// memory at a quarter of the f32 bytes.
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
