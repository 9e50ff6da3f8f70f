"""Mamba2 SSD inter-chunk state recurrence.

Counterpart of `repro.kernels.ssd_scan` (the Pallas TPU kernel
`ssd_scan_bchnp`, reached through `ops.ssd_scan`). Given per-chunk state
contributions S [B, nc, H, N, P] and per-chunk decays d [B, nc, H]:

    h_0 = 0;   h_{c+1} = d_c * h_c + S_c

returns the state before each chunk, h_before [B, nc, H, N, P], and the
final state h_final [B, H, N, P], both f32.

`ssd_scan` launches the hand-written CUDA kernel `csrc/ssd_scan.cu` for
CUDA tensors and runs the plain PyTorch version `ssd_scan_plain` for CPU
tensors; any other device raises. `launches` counts kernel launches.
Neither route has a backward, and both refuse inputs that require grad
while grad mode is on (`build.check_no_grad`).
No model path calls it: the reference's Mamba2 mixer runs the same
recurrence with `lax.scan` (`models/layers.py:ssd_mix_chunked`), so the
port exposes it as the op.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0


def _check_shapes(S, d) -> tuple[int, int, int, int, int]:
    if S.dim() != 5 or d.dim() != 3 or tuple(d.shape) != tuple(S.shape[:3]):
        raise ValueError(f"ssd_scan: S [B,nc,H,N,P] and d [B,nc,H] "
                         f"expected, got {tuple(S.shape)}, {tuple(d.shape)}")
    return tuple(S.shape)


def ssd_scan_plain(S: torch.Tensor, d: torch.Tensor):
    """S: [B,nc,H,N,P]; d: [B,nc,H]. Returns (h_before, h_final), f32.
    The multiply and the add round separately, as the kernel's do."""
    B, nc, H, N, P = _check_shapes(S, d)
    Sf, df = S.float(), d.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=S.device)
    h_before = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                           device=S.device)
    for c in range(nc):
        h_before[:, c] = h
        h = h * df[:, c, :, None, None] + Sf[:, c]
    return h_before, h


def _lib():
    lib = build.load("ssd_scan")
    if lib.ssd_scan_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_f32.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.ssd_scan_f32.restype = i
    return lib


def ssd_scan(S: torch.Tensor, d: torch.Tensor):
    """S: [B,nc,H,N,P]; d: [B,nc,H], contiguous f32 on one device (the
    kernel launches on it).
    Returns (h_before [B,nc,H,N,P], h_final [B,H,N,P]), f32."""
    B, nc, H, N, P = _check_shapes(S, d)
    build.check_no_grad("ssd_scan", S=S, d=d)
    if S.device.type == "cpu":
        return ssd_scan_plain(S, d)
    if S.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {S.device}")
    build.check_one_device("ssd_scan", S=S, d=d)
    for name, t in (("S", S), ("d", d)):
        if (t.dtype != torch.float32 or t.device != S.device
                or not t.is_contiguous()):
            raise ValueError(f"ssd_scan: {name} must be a contiguous "
                             f"float32 tensor on {S.device}, got {t.dtype} "
                             f"on {t.device}")
    h_before = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                           device=S.device)
    h_final = torch.empty((B, H, N, P), dtype=torch.float32,
                          device=S.device)
    if B * H * N * P == 0:
        return h_before, h_final
    with torch.cuda.device(S.device):
        err = _lib().ssd_scan_f32(
            S.data_ptr(), d.data_ptr(), h_before.data_ptr(),
            h_final.data_ptr(), B, nc, H, N * P,
            torch.cuda.current_stream(S.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    global launches
    launches += 1
    return h_before, h_final
