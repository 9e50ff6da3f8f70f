// flash_attention: forward online-softmax attention, written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (body _attn_kernel), reached through
// ops.flash_attention in the model layout. For each batch b, query head
// h (kv head h / (H / KH)) and query row i at position q_pos = q_offset + i:
//
//     s[k]  = (f32(q[b,i,h,:]) * scale) . f32(k[b,k,kh,:])
//     s[k]  = -1e30 where k >= Sk, (causal) k > q_pos,
//             or (window) q_pos - k >= window
//     out   = sum_k exp(s[k] - m) f32(v[b,k,kh,:]) / max(sum_k exp(s[k] - m),
//             1e-30), carried as a running (max m, normalizer, accumulator)
//             over key tiles, stored in f32
//
// What bounds it on an H100: at h2o-danube-3-4b's layer shape (B = 2,
// S = 8192, H = 32, KH = 8, hd = 120, causal, window 4096) the unmasked
// (q, k) pairs are 25.2 M per (b, h), 4 hd FLOPs each: 7.7e11 FLOPs a
// call against ~157 MB of q, k, v and out. That is 0.78 ms at the bf16
// tensor-core peak and 0.05 ms of memory, so the operations bound it.
// This kernel is the f32 route: it does them in fp32 on the CUDA cores
// (67 TFLOP/s peak), no TF32 and no tensor cores, so the f32 result
// keeps f32 accuracy (TF32 would break its 2e-5 tolerance). bf16 inputs
// go to flash_attention_sm90.cu (wgmma and TMA).
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch). The query tile is staged once in shared memory as f32, scaled
// after the cast as the TPU kernel scales it. A loop over key tiles of
// 64 takes the place of the TPU's sequential kv grid axis: each tile of
// K and V is staged as f32 (rows past Sk and the head-dim pad past hd
// are zero), each thread forms a 4 x 4 block of scores, the row max and
// sum go through shuffles across the 16 threads of a row group, and the
// scores, as probabilities, reuse K's shared memory for the P @ V
// product into a 4 x 8 register accumulator (rows ty + 16 i, columns
// tx + 16 j). Key tiles wholly outside the causal window are skipped
// (the TPU kernel only masks them, kernel.py:14-16); that is exact for
// every row that sees at least one key, which the wrapper checks.
// hd <= 128 at any value: hd = 120 is masked at the loads and stores.
// 96.5 KB of dynamic shared memory: two blocks per SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kHD = 128;          // largest head dim
constexpr int kQKS = kHD + 1;     // row stride of the Q and K tiles (floats)
constexpr int kVS = kHD;          // row stride of the V tile
constexpr int kPS = kBK + 1;      // row stride of P (aliases the K tile)
constexpr int kRows = kBQ / 16;   // rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr int kOut = kHD / 16;    // output columns per thread
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kQKS + kBK * kQKS + kBK * kVS);

struct Strides {
  int64_t b, s, h;              // elements; the head-dim axis has stride 1
};

__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Sq, int Sk, int H, int KH, int hd, Strides qs_,
                       Strides ks_, Strides vs_, Strides os_, int causal,
                       int window, int q_offset, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [kBQ][kQKS], scaled
  float* k_s = q_s + kBQ * kQKS;           // [kBK][kQKS]
  float* v_s = k_s + kBK * kQKS;           // [kBK][kVS]
  float* p_s = k_s;                        // [kBQ][kPS] after the scores
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + kh * ks_.h;
  const float* vb = v + b * vs_.b + kh * vs_.h;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const int i = q0 + r;
    q_s[r * kQKS + d] = i < Sq ? qb[i * qs_.s + d] * scale : 0.f;
  }
  // V's head-dim pad is read by the product and never loaded: zero it once
  const int pad = kHD - hd;
  for (int e = tid; e < kBK * pad; e += kThreads) {
    const int r = e / pad;
    v_s[r * kVS + hd + (e - r * pad)] = 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  // keys any row of this tile may see; tiles outside are skipped
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, qp_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();        // the previous tile's P and V are consumed
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const int j = k0 + r;
      const bool in = j < Sk;
      k_s[r * kQKS + d] = in ? kb[j * ks_.s + d] : 0.f;
      v_s[r * kVS + d] = in ? vb[j * vs_.s + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = q_s[(ty + 16 * i) * kQKS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = k_s[(tx + 16 * j) * kQKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool valid = kp < Sk;
        if (causal) valid = valid && kp <= qp;
        if (window > 0) valid = valid && qp - kp < window;
        if (!valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();        // every thread is done reading K
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = p_s[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = v_s[c * kVS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + b * os_.b + r * os_.s + h * os_.h;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) o[d] = acc[i][j] / den;
    }
  }
}

}  // namespace

// q [B,Sq,H,hd], k/v [B,Sk,KH,hd], out [B,Sq,H,hd], f32 on the device,
// each given by its batch, sequence and head strides in elements (the
// head-dim axis contiguous). window 0 = none. Launch on `stream`; return
// cudaGetLastError().
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int B,
    int Sq, int Sk, int H, int KH, int hd, int64_t qsb, int64_t qss,
    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
    int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh,
    int causal, int window, int q_offset, float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const Strides qs_{qsb, qss, qsh}, ks_{ksb, kss, ksh}, vs_{vsb, vss, vsh},
      os_{osb, oss, osh};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<<<grid, kThreads, kSmemBytes,
                           (cudaStream_t)stream>>>(
      q, k, v, out, Sq, Sk, H, KH, hd, qs_, ks_, vs_, os_, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}
