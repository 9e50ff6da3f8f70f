// Split-TF32 products on Hopper's tensor cores, shared by the GraphSAGE
// kernels (graph_aggregate.cu, segment_aggregate.cu).
//
// Why split. The TPU kernels' products are f32. A tf32 operand keeps 10
// explicit mantissa bits, so one tf32 product is off by ~2^-11 relative
// per operand, which fails the 1e-5·max|ref| check by an order of
// magnitude (tests/test_torch_kernels.py emulates it). Each f32 operand
// is split as
//
//     a_hi = tf32_rna(a),  a_lo = tf32_rna(a - a_hi)
//
// (a - a_hi is exact in f32) and a·b is taken as a_hi·b_hi + a_hi·b_lo +
// a_lo·b_hi, with f32 sums. What is left out, a_lo·b_lo and the rounding
// of the lo halves, is ~2^-22 relative. Where one operand is exact in tf32
// (a 0/1 adjacency), its lo half is 0 and its term adds exact zeros. Small
// integers and int8 · 2^-k scales are exact in tf32 (lo = 0), and their
// products and partial sums are exact in f32, so integer inputs give
// bit-exact results.
//
// Layout. tf32 wgmma reads both operands K-major from shared memory (the
// transpose bits exist for 16-bit types only). A tile of R rows (R a
// multiple of 8) by K columns (a multiple of 32) is kept as K / 32 slabs
// of R rows x 128 bytes, with the 128-byte swizzle: the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8). Tiles start 1024-byte aligned. One k8
// step of a wgmma reads 32 bytes of each row: its descriptor starts at
// slab (k / 32), byte 4 (k % 32); 8-row groups are 1024 bytes apart.
//
// Staging. A block brings each operand tile in one go: through TMA where
// the tensor allows it (16-byte aligned base, rows a multiple of 16
// bytes; x, X and A boxes land in the swizzled layout, w's raw block
// unswizzled), else through 4-byte cp.async copies (ragged N, D or F),
// zero-filled outside the operand either way. The hi/lo split then runs
// in place over the staged tile (the swizzle is a permutation of
// positions, so the split is elementwise), and fence.proxy.async makes
// those writes visible to the tensor cores.
//
// Two traps, each of which cost a factor on the card (measured with
// kernels/phase_clocks.py):
//   - every descriptor of a product must be warp-uniform (wg_index()
//     broadcasts the warpgroup index), and no branch that the compiler
//     takes for divergent may sit around or among the products (in
//     segment_aggregate a vote, product_warpgroup, picks the warpgroup;
//     graph_aggregate's two warpgroups each take 32 columns, no branch):
//     otherwise it waits for each product before it issues the next
//     (WARPGROUP.DEPBAR after every HGMMA in the SASS; ptxas's advisory
//     C7520 names the cause);
//   - a / b compiles to a reciprocal, a range check and a slow-path call
//     per element; div_by takes one division per row and an FMA
//     correction per element, rounded the same.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

// Phase clocks of block (0, 0), for a build with -DREPRO_PHASE_CLOCKS only
// (kernels/phase_clocks.py); the normal build compiles the marks away.
#ifdef REPRO_PHASE_CLOCKS
__device__ unsigned long long repro_phase_clocks[16];
#define REPRO_PHASE(i)                                                  \
  do {                                                                  \
    __syncthreads();                                                    \
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)        \
      repro_phase_clocks[i] = clock64();                                \
  } while (0)
extern "C" int repro_read_phase_clocks(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, repro_phase_clocks,
                                   sizeof(repro_phase_clocks));
}
#else
#define REPRO_PHASE(i)
#endif

namespace repro_torch {

constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kTileRows = 64;               // wgmma M
constexpr int kSlabBytes = kTileRows * 128; // one 32-column slab of 64 rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, k) in a swizzled K-major tile of R rows
__device__ __forceinline__ uint32_t sw128(int r, int k, int R) {
  return static_cast<uint32_t>((k >> 5) * R * 128 + r * 128 +
                               ((((k >> 2) & 7) ^ (r & 7)) << 4) +
                               ((k & 3) << 2));
}

// cvt.rna.tf32.f32 as two integer operations (the result is the same for
// finite inputs and the ALU takes them at full rate): round to 10
// explicit mantissa bits, ties away from zero; the low 13 bits come out 0
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 16 bytes, through L2 only (for data that this block wrote to global
// memory earlier)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// generic-proxy writes to shared memory -> visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the shared::cluster address of `addr` (this block's shared memory) in
// block `rank` of the cluster, and a 16-byte load from it
__device__ __forceinline__ uint32_t dsmem_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_smem4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 ld_dsmem4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// ------------------------------------------------------ TMA and mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 2-D or 3-D tensor map into shared memory, completing on
// `bar`; coordinates innermost first, out-of-bounds elements arrive as 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared
// memory by the bulk copy engine, completing on `bar`; both addresses
// 16-byte aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A stage brings a block's operands in one go: through TMA where the
// layout allows (16-byte aligned base and rows), else through cp.async.
// Thread 0 arms the block's mbarrier with the stage's TMA bytes and
// issues the boxes; every thread then waits for its own cp.async copies
// and for the barrier.
struct Stage {
  uint32_t bar;         // the block's mbarrier
  uint32_t parity;      // of its next completion
};

__device__ __forceinline__ void stage_begin(const Stage& st, uint32_t bytes) {
  if (threadIdx.x == 0) {
    // earlier generic writes to these tiles come before the async copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (bytes) mbar_expect_tx(st.bar, bytes);
  }
}

// one box, issued by thread 0
__device__ __forceinline__ void tma_box(const Stage& st, uint32_t dst,
                                        const CUtensorMap* map, int c0,
                                        int c1, int c2) {
  if (threadIdx.x == 0) tma_load(dst, map, st.bar, c0, c1, c2);
}

// a swizzled tile of 64 rows x KC columns from a 3-D map whose boxes are
// 32 columns x 64 rows x 1 with the 128-byte swizzle: KC / 32 boxes of
// kSlabBytes, which land in the tile's layout
__device__ __forceinline__ void tma_rows(const Stage& st, uint32_t dst,
                                         const CUtensorMap* map, int k0,
                                         int r0, int z, int KC) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < KC / 32; ++j)
      tma_load(dst + j * kSlabBytes, map, st.bar, k0 + 32 * j, r0, z);
  }
}

__device__ __forceinline__ void stage_end(Stage& st, bool tma) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tma) {
    mbar_wait(st.bar, st.parity);
    st.parity ^= 1;
  }
  __syncthreads();
}

// The cp.async path of staging, for tensors that TMA cannot take: a
// swizzled K-major tile of 64 rows x KC columns at `dst` <- rows r <
// rows_valid, columns k < k_valid of `src` (row stride ld floats), zeros
// elsewhere, as 4-byte copies (TMA takes every layout that 16-byte copies
// would). Every thread of the block calls it.
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* src,
                                           int ld, int rows_valid,
                                           int k_valid, int KC) {
  for (int i = threadIdx.x; i < kTileRows * KC; i += blockDim.x) {
    const int r = i / KC, k = i % KC;
    const bool ok = r < rows_valid && k < k_valid;
    cp_async4(dst + sw128(r, k, kTileRows),
              ok ? src + (size_t)r * ld + k : src, ok ? 4 : 0);
  }
}

// The same for the raw [KC][64] row-major block of w [D][F] at rows k0..,
// columns f0.. (k < k_valid, f < f_valid; zeros elsewhere), for the
// transposing split below: 4-byte copies when rows of w and its base
// allow them (always for f32), else plain loads (int8 with F not a
// multiple of 4).
template <typename WT>
__device__ __forceinline__ void stage_w_raw(WT* dst, const WT* w, int F,
                                            int k_valid, int f_valid,
                                            int KC) {
  constexpr int kE = (int)sizeof(WT);
  if ((F * kE) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0) {
    const char* wb = reinterpret_cast<const char*>(w);
    const uint32_t d0 = smem_addr(dst);
    constexpr int kPerRow = 64 * kE / 4;
    for (int i = threadIdx.x; i < KC * kPerRow; i += blockDim.x) {
      const int k = i / kPerRow, byte = (i % kPerRow) * 4;
      // f_valid * kE is a multiple of 4: F and f0 are
      const bool ok = k < k_valid && byte < f_valid * kE;
      cp_async4(d0 + k * 64 * kE + byte,
                ok ? wb + (size_t)k * F * kE + byte : wb, ok ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < KC * 64; i += blockDim.x) {
      const int k = i / 64, f = i % 64;
      dst[i] = (k < k_valid && f < f_valid) ? w[(size_t)k * F + f] : WT(0);
    }
  }
}

// hi/lo split, in place: hi[i] <- tf32_rna(v), lo[i] <- tf32_rna(v - hi),
// v = hi[i] · row_scale[row of i] (row_scale in shared memory, or null),
// over a swizzled tile of 64 rows and `nbytes` bytes.
__device__ __forceinline__ void split_tile(float* hi, float* lo, int nbytes,
                                           const float* row_scale) {
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) {
    float4 v = reinterpret_cast<float4*>(hi)[i];
    if (row_scale) {
      const float s = row_scale[(i % (kSlabBytes / 16)) / 8];
      v.x *= s;
      v.y *= s;
      v.z *= s;
      v.w *= s;
    }
    float4 h, l;
    h.x = tf32_rna(v.x);
    h.y = tf32_rna(v.y);
    h.z = tf32_rna(v.z);
    h.w = tf32_rna(v.w);
    l.x = tf32_rna(v.x - h.x);
    l.y = tf32_rna(v.y - h.y);
    l.z = tf32_rna(v.z - h.z);
    l.w = tf32_rna(v.w - h.w);
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// Transposing split of a raw [KC][64] block (see stage_w_raw) into the
// swizzled K-major tiles hi/lo of 64 rows (= the block's columns) by KC:
// v = raw[k][f] · col_scale[f] (col_scale in shared memory, or null). A
// thread takes 4 consecutive k of one column: its reads are a column
// apart, the lanes of a warp read 32 consecutive columns, and each 16-byte
// store lands in its own swizzled chunk, so neither conflicts.
template <typename WT>
__device__ __forceinline__ void split_w(const WT* raw, float* hi, float* lo,
                                        int KC, const float* col_scale) {
  char* hb = reinterpret_cast<char*>(hi);
  char* lb = reinterpret_cast<char*>(lo);
  for (int i = threadIdx.x; i < KC * 16; i += blockDim.x) {
    const int f = i % 64, k = (i / 64) * 4;
    const float s = col_scale ? col_scale[f] : 1.f;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = static_cast<float>(raw[(k + j) * 64 + f]);
      if (col_scale) v[j] *= s;
    }
    float4 h, l;
    h.x = tf32_rna(v[0]);
    h.y = tf32_rna(v[1]);
    h.z = tf32_rna(v[2]);
    h.w = tf32_rna(v[3]);
    l.x = tf32_rna(v[0] - h.x);
    l.y = tf32_rna(v[1] - h.y);
    l.z = tf32_rna(v[2] - h.z);
    l.w = tf32_rna(v[3] - h.w);
    const uint32_t off = sw128(f, k, kTileRows);
    *reinterpret_cast<float4*>(hb + off) = h;
    *reinterpret_cast<float4*>(lb + off) = l;
  }
}

// ------------------------------------------------------------------ wgmma
// shared-memory descriptor, 128-byte swizzle (layout type 1); LBO unused
// for swizzled K-major tiles, SBO = 1024 bytes between 8-row groups
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 32] += A[64 x 8] B[8 x 32], tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 8] B[8 x 64], tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(1));
}
#undef WG_D8

// acc[64 x N] += A · B over K = KC (a multiple of 32) in split tf32:
// a_hi b_hi + a_hi b_lo + a_lo b_hi, one warpgroup, N = 2 R columns (32
// or 64). A is a 64-row swizzled tile, b_hi / b_lo point at N rows of
// 64-row B tiles. Shared memory bounds these products, so one warpgroup
// at N = 64 (A read once) beats two at N = 32 (A read twice), where a
// branch can pick the one warpgroup without making the compiler
// serialize. Every address must be warp-uniform. The caller fences the
// proxies and syncs before, and syncs after if the tiles are rewritten.
template <int R>
__device__ __forceinline__ void split_product(float (&acc)[R], uint32_t a_hi,
                                              uint32_t a_lo, uint32_t b_hi,
                                              uint32_t b_lo, int KC) {
  fence_regs(acc);
  wg_fence();
  for (int slab = 0; slab < KC / 32; ++slab) {
    const uint32_t s0 = slab * kSlabBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t o = s0 + kk * 32;
      wgmma_tf32(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o));
      wgmma_tf32(acc, desc_sw128(a_hi + o), desc_sw128(b_lo + o));
      wgmma_tf32(acc, desc_sw128(a_lo + o), desc_sw128(b_hi + o));
    }
  }
  wg_commit();
  wg_wait0();
  fence_regs(acc);
}

// the warpgroup of this thread, broadcast from lane 0 so that the compiler
// knows it is warp-uniform
__device__ __forceinline__ int wg_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / kWgThreads, 0);
}

// whether this thread's warp is in warpgroup 0, which issues the products:
// a vote, so that the branch on it is uniform to the compiler (a branch it
// takes for divergent makes it serialize the products behind it)
__device__ __forceinline__ bool product_warpgroup() {
  return __any_sync(0xffffffffu, threadIdx.x < kWgThreads);
}

// a / b rounded as IEEE division rounds it, for b >= 1 and no overflow or
// underflow: with inv = 1 / b (rounded), q = a · inv is within an ulp and
// one FMA correction gives the correctly rounded quotient (Markstein).
// One division per row instead of one per element.
__device__ __forceinline__ float div_by(float a, float b, float inv) {
  const float q = a * inv;
  return fmaf(fmaf(-q, b, a), inv, q);
}

// The accumulator fragment of m64nN (f32): element i of thread t of the
// warpgroup is row 16 (t / 32 % 4) + (t % 32) / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int frag_row(int i) {
  return 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4 +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// Split-TF32 tiles of a product over depth D are staged in chunks of at
// most kMaxKC columns, each chunk in one go.
constexpr int kMaxKC = 192;

// Host-side settings are cached per device: a function attribute applies
// to the current device only, and SM counts may differ between devices.
constexpr int kMaxDevices = 64;

// the current device, or -1 (then nothing is cached)
inline int cached_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices ? dev : -1;
}

// streaming multiprocessors of the current device (persistent grids)
inline int sm_count() {
  static int cache[kMaxDevices] = {};
  const int slot = cached_device();
  if (slot >= 0 && cache[slot]) return cache[slot];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 1;
  if (slot >= 0) cache[slot] = n;
  return n;
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// columns of one depth chunk: D padded to 32, cut into the fewest chunks
// of at most `max_kc`, each a multiple of 32
__host__ __device__ inline int chunk_cols(int D, int max_kc) {
  const int dp = round_up(D > 0 ? D : 1, 32);
  const int chunks = (dp + max_kc - 1) / max_kc;
  return round_up((dp + chunks - 1) / chunks, 32);
}

// ------------------------------------------------------------- host: TMA
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime: it is
// looked up with cudaGetDriverEntryPoint, so the library links against
// nothing but the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

constexpr int kErrEntryPoint = 10000;     // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 20000;         // + the CUresult of the encode

// TMA takes a tensor whose base is 16-byte aligned and whose row (inner
// extent times element size) is a multiple of 16 bytes
inline bool tma_ok(const void* base, long long inner, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         inner * elem_bytes % 16 == 0;
}

// a 3-D map over [dim2][dim1][dim0] (dim0 contiguous), boxes of
// box0 x box1 x 1, zeros out of bounds; swizzle128: 128-byte swizzle
// (box0 * elem_bytes must then be 128)
inline int encode_3d(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, int elem_bytes,
                     long long dim0, long long dim1, long long dim2,
                     int box0, int box1, bool swizzle128) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEntryPoint;
  const cuuint64_t dims[3] = {(cuuint64_t)dim0, (cuuint64_t)dim1,
                              (cuuint64_t)(dim2 > 0 ? dim2 : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)(dim0 * elem_bytes),
                                 (cuuint64_t)(dim0 * dim1 * elem_bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

}  // namespace repro_torch
