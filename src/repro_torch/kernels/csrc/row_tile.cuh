// Shared fp32 register-tile product for the hand-written GraphSAGE kernels.
//
// A block of kThreads = 16 x 16 threads owns an output tile of
// kTY * TM rows by kFT = 64 channels. Thread (ty, tx) keeps a TM x 4
// tile in registers: rows ty, ty + 16, ..., channels 4tx .. 4tx + 3. The
// depth axis is walked in chunks of KT. Each chunk of the left operand
// is staged (through registers, one chunk ahead of the arithmetic) in
// shared memory depth-major ([KT][rows + 1]: the padding column spreads
// the transposing stores over the banks) and each chunk of the right
// operand as [KT][64]. Per depth step a thread then reads TM left values
// (broadcasts: a warp spans two row indices) and one float4 of the right
// operand, and issues 4 * TM fused multiply-adds. Each output's sum runs
// over the depth axis in order.
#pragma once

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kTX = 16;                 // thread columns
constexpr int kTY = kThreads / kTX;     // thread rows: 16
constexpr int kTN = 4;                  // channels per thread (a float4)
constexpr int kFT = kTX * kTN;          // channels per block: 64

// A tile of kTY * TM rows, walked in depth chunks of KT.
template <int TM, int KT>
struct RowTile {
  static constexpr int kRows = kTY * TM;
  static constexpr int kLhsStride = kRows + 1;
  static constexpr int kLhsFloats = KT * kLhsStride;   // [KT][kRows + 1]
  static constexpr int kRhsFloats = KT * kFT;          // [KT][kFT]
  // each thread's share of one chunk of each operand
  static constexpr int kL = kRows * KT / kThreads;
  static constexpr int kR = kRhsFloats / kThreads;
  static_assert(kL * kThreads == kRows * KT, "lhs chunk split");
  static_assert(kR * kThreads == kRhsFloats, "rhs chunk split");
};

// One chunk of each operand travels global memory -> registers ->
// shared memory. Each thread loads its share of the next chunk into
// registers (all loads independent, so they are in flight together)
// while the block computes on the current one.

// v[t] = lhs(r0 + r, k0 + k) for this thread's share of one chunk;
// `lhs` returns 0 outside the operand.
template <int TM, int KT, typename Lhs>
__device__ __forceinline__ void load_lhs(float (&v)[RowTile<TM, KT>::kL],
                                         int r0, int k0, Lhs lhs) {
#pragma unroll
  for (int t = 0; t < RowTile<TM, KT>::kL; ++t) {
    const int i = threadIdx.x + t * kThreads;
    v[t] = lhs(r0 + i / KT, k0 + i % KT);
  }
}

// lhs_s[k][r] = v, depth-major.
template <int TM, int KT>
__device__ __forceinline__ void store_lhs(
    float* lhs_s, const float (&v)[RowTile<TM, KT>::kL]) {
#pragma unroll
  for (int t = 0; t < RowTile<TM, KT>::kL; ++t) {
    const int i = threadIdx.x + t * kThreads;
    lhs_s[(i % KT) * RowTile<TM, KT>::kLhsStride + i / KT] = v[t];
  }
}

// v[t] = rhs(k0 + k, c) for this thread's share of one [KT][64] chunk;
// `rhs` returns 0 outside the operand.
template <int TM, int KT, typename Rhs>
__device__ __forceinline__ void load_rhs(float (&v)[RowTile<TM, KT>::kR],
                                         int k0, Rhs rhs) {
#pragma unroll
  for (int t = 0; t < RowTile<TM, KT>::kR; ++t) {
    const int i = threadIdx.x + t * kThreads;
    v[t] = rhs(k0 + i / kFT, i % kFT);
  }
}

template <int TM, int KT>
__device__ __forceinline__ void store_rhs(
    float* rhs_s, const float (&v)[RowTile<TM, KT>::kR]) {
#pragma unroll
  for (int t = 0; t < RowTile<TM, KT>::kR; ++t) {
    rhs_s[threadIdx.x + t * kThreads] = v[t];
  }
}

// acc[i][j] += sum_{k < KT} lhs_s[k][ty + 16 i] * rhs[k][4 tx + j],
// with `rhs` a [KT][64] block in shared memory (16-byte aligned).
template <int TM, int KT>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][kTN],
                                          const float* lhs_s,
                                          const float* rhs) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const float4 b =
        *reinterpret_cast<const float4*>(rhs + k * kFT + tx * kTN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a =
          lhs_s[k * RowTile<TM, KT>::kLhsStride + ty + kTY * i];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
}

// acc = sum_{k < depth} lhs(r0 + row, k) * rhs(k, channel) over the
// thread's rows and channels; the next chunk's loads overlap the current
// chunk's multiply-adds. Every thread of the block must call this.
template <int TM, int KT, typename Lhs, typename Rhs>
__device__ __forceinline__ void tile_product(float (&acc)[TM][kTN],
                                             float* lhs_s, float* rhs_s,
                                             int r0, int depth, Lhs lhs,
                                             Rhs rhs) {
  float lv[RowTile<TM, KT>::kL], rv[RowTile<TM, KT>::kR];
  load_lhs<TM, KT>(lv, r0, 0, lhs);
  load_rhs<TM, KT>(rv, 0, rhs);
  for (int k0 = 0; k0 < depth; k0 += KT) {
    store_lhs<TM, KT>(lhs_s, lv);
    store_rhs<TM, KT>(rhs_s, rv);
    __syncthreads();
    if (k0 + KT < depth) {
      load_lhs<TM, KT>(lv, r0, k0 + KT, lhs);
      load_rhs<TM, KT>(rv, k0 + KT, rhs);
    }
    fma_chunk<TM, KT>(acc, lhs_s, rhs_s);
    __syncthreads();
  }
}

}  // namespace repro_torch
