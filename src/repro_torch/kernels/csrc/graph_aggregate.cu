// graph_aggregate: the fused dense GraphSAGE hop, written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/graph_aggregate/kernel.py:
// graph_aggregate_bnd (body _kernel). Per graph b of the batch:
//
//     out[b] = A[b] @ act(X[b] @ W)      A [N, N], X [N, D], W [D, F]
//     mean: out[b][i] /= max(sum_j A[b][i][j], 1)
//
// What bounds it on an H100: at the serving shape (B = 128 graphs,
// N = 64 nodes, D = F = 192) the call moves ~15 MB and does ~0.8 GFLOP
// in fp32, so it sits on the fp32 CUDA-core rate (~67 TFLOP/s), not on
// memory. The message tensor act(X W) is N x F per graph and would be
// written and read back through device memory by an unfused version.
//
// Design: one block per (F-tile of 64 channels, graph). The block first
// forms msg = act(X[b] @ W[:, tile]) with the shared register-tile
// product (row_tile.cuh, 64-row tiles, 4 x 4 outputs per thread) and
// keeps it in shared memory (N x 64 floats, 16 KB at N = 64), then
// streams A[b] through shared memory in 16-column chunks and multiplies
// it with msg read straight from shared memory; the row sums of A[b]
// (for mean) come from the same staged chunks. Global loads run one
// chunk ahead of the arithmetic. The message tensor never leaves
// the SM. Ragged N, D and F are masked at the loads and stores. Plain
// fp32 FMA, no tensor cores: wgmma/TMA are later work.
#include <cuda_runtime.h>

#include "row_tile.cuh"

namespace {

using namespace repro_torch;

constexpr int kTM = 4;                            // rows per thread
constexpr int kKT = 16;                           // depth chunk
using Tile = RowTile<kTM, kKT>;
constexpr int kRows = Tile::kRows;                // 64 rows per tile

__host__ __device__ inline int padded_rows(int N) {
  return (N + kRows - 1) / kRows * kRows;
}

__global__ void __launch_bounds__(kThreads)
graph_aggregate_kernel(const float* __restrict__ adj,
                       const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int N, int D, int F, int relu, int mean) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded_rows(N);
  float* msg = smem;                         // [np][kFT]
  float* rhs_s = msg + np * kFT;             // [kKT][kFT]
  float* lhs_s = rhs_s + Tile::kRhsFloats;   // [kKT][kRows + 1]
  float* deg = lhs_s + Tile::kLhsFloats;     // [kRows]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const float* xb = x + (size_t)b * N * D;
  const float* ab = adj + (size_t)b * N * N;

  // phase 1: msg = act(X[b] @ W[:, f0:f0 + 64]); rows >= N come out 0
  for (int r0 = 0; r0 < N; r0 += kRows) {
    float acc[kTM][kTN] = {};
    tile_product<kTM, kKT>(
        acc, lhs_s, rhs_s, r0, D,
        [&](int r, int k) {
          return (r < N && k < D) ? xb[(size_t)r * D + k] : 0.f;
        },
        [&](int k, int c) {
          return (k < D && f0 + c < F) ? w[(size_t)k * F + f0 + c] : 0.f;
        });
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float v = acc[i][j];
        msg[(r0 + ty + kTY * i) * kFT + tx * kTN + j] =
            relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
  __syncthreads();

  // phase 2: out[b][:, tile] = A[b] @ msg, msg read from shared memory;
  // thread t < 64 also sums row r0 + t of A[b] (in column order, for mean)
  for (int r0 = 0; r0 < N; r0 += kRows) {
    const auto a_at = [&](int r, int j) {
      return (r < N && j < N) ? ab[(size_t)r * N + j] : 0.f;
    };
    float acc[kTM][kTN] = {};
    float rowsum = 0.f;
    float av[Tile::kL];
    load_lhs<kTM, kKT>(av, r0, 0, a_at);
    for (int j0 = 0; j0 < N; j0 += kKT) {
      store_lhs<kTM, kKT>(lhs_s, av);
      __syncthreads();
      if (j0 + kKT < N) load_lhs<kTM, kKT>(av, r0, j0 + kKT, a_at);
      fma_chunk<kTM, kKT>(acc, lhs_s, msg + j0 * kFT);
      if (threadIdx.x < kRows) {
#pragma unroll
        for (int k = 0; k < kKT; ++k) {
          rowsum += lhs_s[k * Tile::kLhsStride + threadIdx.x];
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < kRows) deg[threadIdx.x] = rowsum;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = r0 + ty + kTY * i;
      if (r >= N) continue;
      const float den = fmaxf(deg[ty + kTY * i], 1.f);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int f = f0 + tx * kTN + j;
        if (f < F) {
          out[((size_t)b * N + r) * F + f] =
              mean ? acc[i][j] / den : acc[i][j];
        }
      }
    }
    __syncthreads();   // deg is rewritten by the next row tile
  }
}

}  // namespace

// Shared memory the kernel needs for N nodes (the wrapper checks it
// against the card's limit before launching).
extern "C" int graph_aggregate_smem_bytes(int N) {
  const int np = padded_rows(N);
  return (int)(sizeof(float) * ((size_t)np * kFT + Tile::kRhsFloats +
                                Tile::kLhsFloats + kRows));
}

// adj [B,N,N], x [B,N,D], w [D,F], out [B,N,F]: contiguous fp32 on the
// device. Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int graph_aggregate_f32(const float* adj, const float* x,
                                   const float* w, float* out, int B, int N,
                                   int D, int F, int relu, int mean,
                                   void* stream) {
  const int smem = graph_aggregate_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      graph_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + kFT - 1) / kFT, B);
  graph_aggregate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      adj, x, w, out, N, D, F, relu, mean);
  return (int)cudaGetLastError();
}
