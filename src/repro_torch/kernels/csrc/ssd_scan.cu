// ssd_scan: the Mamba2 SSD inter-chunk state recurrence, written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py: ssd_scan_bchnp
// (body _kernel). Over per-chunk state contributions S [B, nc, H, N, P]
// and per-chunk decays d [B, nc, H], all f32:
//
//     h_0 = 0;   h_before[c] = h_c;   h_{c+1} = d_c * h_c + S_c
//     h_final = h_nc
//
// What bounds it on an H100: one read of S and one write of h_before
// (plus h_final and d): at Mamba2-2.7b's full shapes (H = 80, N = 128,
// P = 64) with B = 2 and nc = 32, 167.8 MB each way, 0.10 ms at
// 3.35 TB/s; two FLOPs per element, so bytes bound it.
//
// Design: the recurrence is independent per state element, so each
// thread owns one (b, h, n, p) element and streams the nc chunks in
// order in a register: it writes h_before[c] and then updates. The state
// before chunk 0 is exactly 0. Neighbouring threads take neighbouring
// (n, p), so every load and store of a warp is one contiguous 128-byte
// line; the chunk loop is unrolled so that several loads are in flight.
// The multiply and the add round separately (no fused multiply-add), as
// the plain version's two PyTorch ops do, so the two agree bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ S, const float* __restrict__ d,
                float* __restrict__ h_before, float* __restrict__ h_final,
                int B, int nc, int H, int NP) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)B * H * NP) return;
  const int e = (int)(idx % NP);
  const int64_t bh = idx / NP;
  const int h = (int)(bh % H);
  const int b = (int)(bh / H);
  const int64_t chunk = (int64_t)H * NP;    // stride of c in S, h_before
  const int64_t base = (int64_t)b * nc * chunk + (int64_t)h * NP + e;
  const float* s = S + base;
  float* hb = h_before + base;
  const float* dd = d + (int64_t)b * nc * H + h;
  float st = 0.f;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    hb[c * chunk] = st;
    st = __fadd_rn(__fmul_rn(st, dd[c * H]), s[c * chunk]);
  }
  h_final[idx] = st;
}

}  // namespace

// S, h_before [B,nc,H,N,P], d [B,nc,H], h_final [B,H,N,P]: contiguous f32
// on the device; NP = N * P. Launch on `stream`; return cudaGetLastError().
extern "C" int ssd_scan_f32(const float* S, const float* d, float* h_before,
                            float* h_final, int B, int nc, int H, int NP,
                            void* stream) {
  const int64_t n = (int64_t)B * H * NP;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  ssd_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      S, d, h_before, h_final, B, nc, H, NP);
  return (int)cudaGetLastError();
}
