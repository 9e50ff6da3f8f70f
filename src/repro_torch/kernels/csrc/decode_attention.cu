// decode_attention: single-query attention over a key/value cache, the
// decode step of every GQA, sliding-window and cross-attention layer of
// the LM zoo, written for sm_90a.
//
// Replaces no TPU kernel: the reference's `cache_attention`
// (src/repro/models/layers.py) is plain jnp left to XLA. It was added
// because the port's plain version upcast the whole cache to f32 and
// copied each operand again for its einsum: ~75 % of musicgen-large's
// decode step went to those copies. For row b and query head h (kv head
// g = h / rep):
//
//     s[t] = f32(q[b,h] * scale) . f32(k[b,t,g])   (q * scale in q's dtype)
//     s[t] = -1e30 where k_pos[b,t] < 0, k_pos > pos, or (window)
//            pos - k_pos >= window; no mask without k_pos
//     out  = softmax_t(s) @ f32(v[b,:,g]), stored in q's dtype
//
// over the slots t < n that the caller names: the slots at or beyond n
// hold no visible key (a full cache writes position p at slot p, a ring
// at p % C), so they are not read. Only the order of the f32 sums
// differs from the plain version: an online softmax over slot tiles.
//
// What bounds it on an H100: one read of the n slots of K and V in the
// cache's dtype, 4 * n * hd bytes a (row, kv head) in bf16; at
// musicgen-large's decode step (B = 64, 32 kv heads, hd 64) 0.52 MB a
// slot and layer, at position 250 131 MB a layer, 39 us at 3.35 TB/s.
// About 2 * rep FLOP a byte, so bytes bound it at every rep of the zoo.
//
// Design: one block owns one (row, kv head), all `rep` of its query
// heads, and one range of slots (a split of whole tiles; more than one
// only where the rows and heads alone would fill the card less than
// twice, and then a second kernel, one block a (row, query head), merges
// the splits' (max, sum, acc) from an f32 scratch). The caller picks the
// tile and the splits (kernels/decode_attention.py `tile_slots`, `plan`).
// It streams K and V tiles of `tile` slots into shared memory with
// 16-byte cp.async copies, double-buffered, so that the next tile loads
// while this one is used. Per tile: each thread takes (head, slot) pairs
// and forms their scores in f32 from shared memory; one warp a query head
// takes the tile's max, rescales the running sum and turns the scores
// into probabilities; then each thread accumulates P.V for its 16-byte
// chunks of the output in f32 registers, several threads a chunk over
// interleaved slots where the chunks are fewer than the threads. Rows of
// the tiles are padded to an odd number of 16-byte units, so that the
// eight threads of a quarter warp reading eight rows hit eight bank
// groups.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;     // the reference's mask value
constexpr int kMaxAcc = 32;           // f32 accumulators of one thread
constexpr int kStageBytes = 36864;    // K and V of one tile, at most

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* k_pos;                   // null: every slot visible
  void* out;                          // [B, 1, H, hd], contiguous
  float* part;                        // splits > 1: (m, l) then acc
  int bkh, KH, rep, hd, n, chunk, splits, pos, window, tile;
  float scale;                        // 1/sqrt(hd), rounded to q's dtype
  int64_t q_sb, q_sh, k_sb, k_st, k_sg, v_sb, v_st, v_sg, kp_sb, kp_st;
};

struct F32 {
  using T = float;
  static constexpr int kVec = 4;      // elements in 16 bytes
  __device__ static float f32(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static void load16(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
};

// bf16 kept as its 16 bits: f32(x) is x << 16, exactly
struct BF16 {
  using T = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float f32(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  __device__ static uint16_t to_bits(float x) {   // round to nearest even
    const uint32_t u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;    // NaN
    return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  }
  __device__ static float round(float x) { return f32(to_bits(x)); }
  __device__ static void store(uint16_t* p, float x) { *p = to_bits(x); }
  __device__ static void load16(const uint16_t* p, float* f) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__host__ __device__ inline int pitch(int hd, int vec) {
  // a row of hd elements, padded to an odd number of 16-byte units
  return (hd / vec) % 2 == 0 ? hd + vec : hd;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(const Params& p, int b, int t) {
  if (p.k_pos == nullptr) return true;
  const int kp = p.k_pos[b * p.kp_sb + t * p.kp_st];
  return kp >= 0 && kp <= p.pos && (p.window <= 0 || p.pos - kp < p.window);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  using T = typename E::T;
  constexpr int kVec = E::kVec;
  constexpr int kUnits = kMaxAcc / kVec;    // output chunks of a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bg = blockIdx.x, split = blockIdx.y;
  const int b = bg / p.KH, g = bg - b * p.KH;
  const int rep = p.rep, hd = p.hd, tile = p.tile;
  const int nvec = hd / kVec, ld = pitch(hd, kVec);
  const int t_begin = split * p.chunk;
  const int t_end = min(p.n, t_begin + p.chunk);

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                   // [2][tile][ld]
  T* vs = ks + 2 * tile * ld;                           // [2][tile][ld]
  float* qs = reinterpret_cast<float*>(vs + 2 * tile * ld);  // [rep][hd]
  float* ss = qs + rep * hd;                            // [rep][tile]
  float* m_run = ss + rep * tile;                       // [rep]
  float* l_run = m_run + rep;                           // [rep]
  float* alpha = l_run + rep;                           // [rep]
  float* red = alpha + rep;                             // [kThreads][kVec]

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sg;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sg;
  auto load_tile = [&](int t0, int stage) {
    const int len = min(tile, t_end - t0);
    T* kd = ks + stage * tile * ld;
    T* vd = vs + stage * tile * ld;
    for (int i = tid; i < len * nvec; i += kThreads) {
      const int r = i / nvec, c = (i - r * nvec) * kVec;
      cp_async16(kd + r * ld + c, kb + (int64_t)(t0 + r) * p.k_st + c);
      cp_async16(vd + r * ld + c, vb + (int64_t)(t0 + r) * p.v_st + c);
    }
    cp_async_commit();
  };
  load_tile(t_begin, 0);

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = E::round(E::f32(qb[(int64_t)(g * rep + r) * p.q_sh + d])
                     * p.scale);
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  // this thread's output chunks: unit u = (head r, chunk c); with fewer
  // units than threads, J threads share a unit over slots j, j + J, ...
  const int units = rep * nvec;
  const int J = units >= kThreads ? 1 : kThreads / units;
  const int per = units >= kThreads ? (units + kThreads - 1) / kThreads : 1;
  const int j = J > 1 ? tid / units : 0;
  float acc[kUnits][kVec];
#pragma unroll
  for (int i = 0; i < kUnits; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;

  const int ntiles = (t_end - t_begin + tile - 1) / tile;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_begin + it * tile, len = min(tile, t_end - t0);
    const int stage = it & 1;
    if (it + 1 < ntiles) {
      load_tile(t0 + tile, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + stage * tile * ld;
    const T* vt = vs + stage * tile * ld;

    for (int i = tid; i < rep * len; i += kThreads) {
      const int r = i / len, t = i - r * len;
      float s = kMasked;
      if (visible(p, b, t0 + t)) {
        const float* qr = qs + r * hd;
        const T* kr = kt + t * ld;
        s = 0.f;
        for (int c = 0; c < hd; c += kVec) {
          float kf[kVec];
          E::load16(kr + c, kf);
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + c + e);
            s = fmaf(q4.x, kf[e], s);
            s = fmaf(q4.y, kf[e + 1], s);
            s = fmaf(q4.z, kf[e + 2], s);
            s = fmaf(q4.w, kf[e + 3], s);
          }
        }
      }
      ss[r * tile + t] = s;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kWarps) {
      float* sr = ss + r * tile;
      float mx = -INFINITY;
      for (int t = lane; t < len; t += 32) mx = fmaxf(mx, sr[t]);
      const float m_old = m_run[r], m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < len; t += 32) {
        const float e = expf(sr[t] - m_new);
        sr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l_run[r] = l_run[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = J > 1 ? tid - j * units : tid + i * kThreads;
      if (i >= per || u >= units || j >= J) continue;
      const int r = u / nvec, c = (u - r * nvec) * kVec;
      const float a = alpha[r];
      const float* pr = ss + r * tile;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] *= a;
      for (int t = j; t < len; t += J) {
        const float w = pr[t];
        float vf[kVec];
        E::load16(vt + t * ld + c, vf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(w, vf[e], acc[i][e]);
      }
    }
    __syncthreads();   // the next tile's copies overwrite this stage
  }

  if (J > 1) {         // the J partial sums of a unit, through red
    if (j < J)
#pragma unroll
      for (int e = 0; e < kVec; ++e) red[tid * kVec + e] = acc[0][e];
    __syncthreads();
    if (tid < units)
      for (int jj = 1; jj < J; ++jj)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[0][e] += red[(jj * units + tid) * kVec + e];
  }
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = J > 1 ? tid : tid + i * kThreads;
    if (i >= per || u >= units) continue;
    const int r = u / nvec, c = (u - r * nvec) * kVec;
    const int64_t row = (int64_t)bg * rep + r;   // (b, h) of out [B,1,H,hd]
    if (p.splits == 1) {
      T* o = static_cast<T*>(p.out) + row * hd + c;
      const float l = l_run[r];
#pragma unroll
      for (int e = 0; e < kVec; ++e) E::store(o + e, acc[i][e] / l);
    } else {
      const int64_t idx = ((int64_t)bg * p.splits + split) * rep + r;
      float* pa = p.part + (int64_t)2 * p.bkh * p.splits * rep
                  + idx * hd + c;
#pragma unroll
      for (int e = 0; e < kVec; ++e) pa[e] = acc[i][e];
      if (c == 0) {
        p.part[2 * idx] = m_run[r];
        p.part[2 * idx + 1] = l_run[r];
      }
    }
  }
}

// merges the splits of (row, kv head) blockIdx.x for its query head
// blockIdx.y: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M
// the largest m_s
template <typename E>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const Params p) {
  using T = typename E::T;
  const int bg = blockIdx.x, r = blockIdx.y;
  const float* pacc = p.part + (int64_t)2 * p.bkh * p.splits * p.rep;
  const int64_t first = (int64_t)bg * p.splits * p.rep + r;
  for (int d = threadIdx.x; d < p.hd; d += kThreads) {
    float m = -INFINITY;
    for (int s = 0; s < p.splits; ++s)
      m = fmaxf(m, p.part[2 * (first + (int64_t)s * p.rep)]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const int64_t idx = first + (int64_t)s * p.rep;
      const float w = expf(p.part[2 * idx] - m);
      l = fmaf(p.part[2 * idx + 1], w, l);
      o = fmaf(pacc[idx * p.hd + d], w, o);
    }
    E::store(static_cast<T*>(p.out) + ((int64_t)bg * p.rep + r) * p.hd + d,
             o / l);
  }
}

size_t smem_bytes(int hd, int esize, int rep, int tile) {
  const size_t kv = (size_t)4 * tile * pitch(hd, 16 / esize) * esize;
  return kv + sizeof(float) * ((size_t)rep * hd + (size_t)rep * tile
                               + 3 * (size_t)rep
                               + (size_t)kThreads * (16 / esize));
}

template <typename E>
int launch(Params p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd, sizeof(typename E::T), p.rep, p.tile);
  if (smem > 48 * 1024) {
    // above 48 KB a kernel needs the opt-in, set once a device
    static int opted[64] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if ((size_t)opted[dev] < smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_attention_kernel<E>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      opted[dev] = (int)smem;
    }
  }
  decode_attention_kernel<E><<<dim3(p.bkh, p.splits), kThreads, smem,
                               stream>>>(p);
  if (p.splits > 1)
    decode_attention_combine<E><<<dim3(p.bkh, p.rep), kThreads, 0,
                                  stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,1,H,hd] (strides q_sb, q_sh; hd contiguous); k, v [B,C,KH,hd]
// (strides *_sb, *_st, *_sg; hd contiguous; 16-byte aligned pointer and
// strides); k_pos [B,C] int32 (strides kp_sb, kp_st) or null; out
// [B,1,H,hd] contiguous; part: f32 scratch of B*KH*splits*rep*(hd + 2)
// when splits > 1. bf16 != 0: q, k, v, out bf16, else f32. Slots [0, n),
// split s over [s*chunk, min(n, (s+1)*chunk)), each non-empty, read in
// tiles of `tile` slots whose K and V rows (padded to an odd number of
// 16-byte units) take at most kStageBytes. Launches on `stream`; returns
// cudaGetLastError() (or the opt-in's error, or cudaErrorInvalidValue for
// a tile that does not fit).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const int* k_pos,
    void* out, float* part, int bf16, int B, int KH, int rep, int hd, int n,
    int splits, int chunk, int tile, int pos, int window, float scale,
    int64_t q_sb,
    int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sg, int64_t v_sb,
    int64_t v_st, int64_t v_sg, int64_t kp_sb, int64_t kp_st,
    void* stream) {
  const int esize = bf16 ? 2 : 4;
  if (tile < 1 || 2 * tile * pitch(hd, 16 / esize) * esize > kStageBytes)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, k_pos, out, part, B * KH, KH, rep, hd, n, chunk, splits,
           pos, window, tile, scale, q_sb, q_sh, k_sb, k_st, k_sg, v_sb, v_st,
           v_sg, kp_sb, kp_st};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(p, s) : launch<F32>(p, s);
}
