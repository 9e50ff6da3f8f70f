// The split-TF32 pieces that the two f32 flash kernels share
// (flash_attention_tf32.cu at hd <= 128, flash_attention_hd256_tf32.cu at
// 128 < hd <= 256): the pre-pass that writes K and V^T as swizzled hi/lo
// tiles, and the tf32 wgmma products of their tiles.
#pragma once

#include "tf32_mma.cuh"

namespace repro_torch {

constexpr int kSplitThreads = 256;        // split_kv

struct KVShape {
  int Sk, KH, hd, n_tiles;
  int64_t ksb, kss, ksh, vsb, vss, vsh;
};

// The key held in column `kk` of a V^T tile. The score accumulator holds,
// for k8 group g, columns 8g + 2(t%4) and +1 of rows r and r + 8
// (frag_row/frag_col); the tf32 A fragment of an m64k8 slice wants
// columns t%4 and t%4 + 4. A sum over keys does not care about their
// order, so k-index j of each group of 8 holds key 2j (j < 4) or
// 2(j - 4) + 1: then the accumulator's registers {s[4g], s[4g+2],
// s[4g+1], s[4g+3]} are P's A fragment as they stand.
__device__ __forceinline__ int vt_key(int kk) {
  return (kk & ~7) + 2 * (kk & 3) + ((kk >> 2) & 1);
}

// byte offset of k8 step kk in a swizzled K-major tile of R rows
__host__ __device__ constexpr uint32_t kstep(int kk, int R) {
  return (uint32_t)((kk / 4) * R * 128 + (kk % 4) * 32);
}

// Pre-pass: one block per (key tile of BK keys, kv head, batch) writes
// [b][kh][tile] -> K_hi | K_lo | Vt_hi | Vt_lo into `scratch`, each half
// BK x HD floats in the swizzled K-major tile layout (K: BK rows of HD;
// V^T: HD rows of BK keys, permuted by vt_key), zeros past hd and Sk. K
// and V tiles go through shared memory (BK x (HD + 1) floats, static: at
// most 48 KB), then out as 16-byte stores in the scratch's order.
template <int HD, int BK>
__global__ void __launch_bounds__(kSplitThreads)
split_kv(const float* __restrict__ k, const float* __restrict__ v,
         uint8_t* __restrict__ scratch, const KVShape sh) {
  __shared__ float raw[BK][HD + 1];
  constexpr int kTile = BK * HD * 4;
  const int t = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  uint8_t* dst =
      scratch + (((size_t)b * sh.KH + kh) * sh.n_tiles + t) * 4 * kTile;
  for (int part = 0; part < 2; ++part) {       // 0: K, 1: V^T
    const float* src = part ? v + b * sh.vsb + kh * sh.vsh
                            : k + b * sh.ksb + kh * sh.ksh;
    const int64_t ss = part ? sh.vss : sh.kss;
    for (int e = threadIdx.x; e < BK * HD; e += kSplitThreads) {
      const int r = e / HD, d = e % HD, key = t * BK + r;
      raw[r][d] = (key < sh.Sk && d < sh.hd) ? src[key * ss + d] : 0.f;
    }
    __syncthreads();
    float4* hi = reinterpret_cast<float4*>(dst + part * 2 * kTile);
    float4* lo = reinterpret_cast<float4*>(dst + (part * 2 + 1) * kTile);
    const int R = part ? HD : BK;            // rows of the K-major tile
    for (int c = threadIdx.x; c < kTile / 16; c += kSplitThreads) {
      // chunk c of the tile: row, and its first column after the swizzle
      const int slab = c / (R * 8), row = (c / 8) % R;
      const int col0 = slab * 32 + (((c % 8) ^ (row & 7)) << 2);
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = part ? raw[vt_key(col0 + j)][row] : raw[row][col0 + j];
      float4 h, l;
      h.x = tf32_rna(x[0]);
      h.y = tf32_rna(x[1]);
      h.z = tf32_rna(x[2]);
      h.w = tf32_rna(x[3]);
      l.x = tf32_rna(x[0] - h.x);
      l.y = tf32_rna(x[1] - h.y);
      l.z = tf32_rna(x[2] - h.z);
      l.w = tf32_rna(x[3] - h.w);
      hi[c] = h;
      lo[c] = l;
    }
    __syncthreads();
  }
}

// -------------------------------------------------------------- wgmma
#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15}"
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32, both from shared memory;
// `acc` 0 overwrites d
template <int acc>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16
      ", %16, %17, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], tf32, both from shared memory
template <int acc>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64]: A from registers (the m64k8 tf32
// fragment: rows r, r + 8 of the warp's 16, columns t%4, t%4 + 4)
template <int acc>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64 x 128] (+)= A[64 x 8] B[8 x 128], A from registers
template <int acc>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
#undef WG_D8
#undef WG_R16
#undef WG_R32
#undef WG_R64

}  // namespace repro_torch
