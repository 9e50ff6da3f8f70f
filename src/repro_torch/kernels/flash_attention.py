"""Forward flash attention in the model layout [B, S, H, hd].

Counterpart of `repro.kernels.flash_attention` (the Pallas TPU kernel
`flash_attention_bhsd`, reached through `ops.flash_attention`, which
takes the same [B, S, H, hd] layout):

    s[q, k] = (f32(q) * 1/sqrt(hd)) . f32(k)      kv head h // (H // KH)
    masked  = k_pos >= Sk, or (causal) k_pos > q_pos,
              or (window) q_pos - k_pos >= window     ->  s = -1e30
    out     = softmax_k(s) @ f32(v), in q's dtype     (q_pos = q_offset + i)

`flash_attention` routes by device, dtype and head dim: up to hd 128,
bf16 CUDA tensors launch the tensor-core kernel
`csrc/flash_attention_sm90.cu` (wgmma and TMA; `launches_tc`) and f32
CUDA tensors the split-TF32 tensor-core kernel
`csrc/flash_attention_tf32.cu` (wgmma, bulk copies; `launches_f32`); for
128 < hd <= 256 (recurrentgemma-9b's hd 256) bf16 launches
`csrc/flash_attention_hd256.cu` (wgmma with TMA; `launches_hd256`) and
f32 the split-TF32 kernel `csrc/flash_attention_hd256_tf32.cu` (wgmma,
bulk copies; `launches_hd256_f32`); hd > 256 raises (the reference takes
any hd; no arch of the zoo goes past 256). The bf16 hd <= 128 kernel is
built at four (block_q, block_k) shapes, (128, 128) by default; each
other route at one (`BLOCK_SHAPES`); `block_candidates` lists a route's
shapes for the tile-size autotuner, as the reference's `ops` module
lists the TPU kernel's, and a shape the route is not built at raises on
either device. Each kernel launches on its
tensors' device; CPU tensors run the plain PyTorch version
`flash_attention_plain` at any hd; any other device raises, and a failed
build or launch raises. `launches` counts every kernel launch (an f32
route's key/value split pre-pass and attention kernel count as one). The
kernels have no backward (nor has the TPU kernel), so every route
refuses q, k or v that require grad while grad mode is on
(`build.check_no_grad`): a
model with `use_pallas_attn` trains on neither device.

The plain version repeats the TPU kernel's arithmetic, not the model's
`chunked_attention`: the TPU kernel casts q to f32 and scales it there,
while `chunked_attention` scales q in q's dtype before the cast, which in
bf16 is one rounding more. It takes a dense softmax over all keys, one
block of query rows at a time to bound its memory.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

launches = 0
launches_tc = 0             # bf16: csrc/flash_attention_sm90.cu
launches_f32 = 0            # f32: csrc/flash_attention_tf32.cu
launches_hd256 = 0          # bf16, hd > 128: csrc/flash_attention_hd256.cu
launches_hd256_f32 = 0      # f32, hd > 128: csrc/flash_attention_hd256_tf32.cu
# (block_q, block_k) each route's kernel is built at, the default first
BLOCK_SHAPES = {"sm90": ((128, 128), (128, 64), (64, 128), (64, 64)),
                "tf32": ((64, 64),), "hd256": ((128, 64),),
                "hd256_f32": ((64, 32),)}
launches_sm90 = dict.fromkeys(BLOCK_SHAPES["sm90"], 0)  # by block shape
NEG_INF = -1e30
TC_HEAD_DIM = 128           # the sm90 and tf32 kernels' tiles hold hd <= 128
MAX_HEAD_DIM = 256          # the hd256 kernels' tiles hold hd <= 256
PLAIN_BLOCK_Q = 512         # query rows per step of the plain version


def _check_shapes(q, k, v) -> tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,Sq,H,hd] and k, v "
                         f"[B,Sk,KH,hd] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KH == 0 or H % KH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H % KH must be 0)")
    return B, Sq, Sk, H, KH, hd


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int | None = None, q_offset: int = 0,
                          exact: bool = False) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KH,hd]. Returns [B,Sq,H,hd] in q's
    dtype. The TPU kernel's arithmetic as a dense masked softmax.
    `exact`: everything after q·scale (still formed in f32) in float64,
    rounded to q's dtype once at the end: the reference of the f32
    kernels' checks on the card, where PyTorch's f32 products themselves
    land up to 2x the f32 limit from it (hd 256, q x 3: PERF.md)."""
    B, Sq, Sk, H, KH, hd = _check_shapes(q, k, v)
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    acc = torch.float64 if exact else torch.float32
    kf = k.to(acc).permute(0, 2, 3, 1)[:, :, None]      # [B,KH,1,hd,Sk]
    vf = v.to(acc).permute(0, 2, 1, 3)[:, :, None]      # [B,KH,1,Sk,hd]
    k_pos = torch.arange(Sk, device=q.device)
    out = torch.empty_like(q)
    for s0 in range(0, Sq, PLAIN_BLOCK_Q):
        n = min(PLAIN_BLOCK_Q, Sq - s0)
        qb = (q[:, s0:s0 + n].float() * scale).to(acc)  # [B,n,H,hd]
        qb = qb.permute(0, 2, 1, 3).reshape(B, KH, rep, n, hd)
        s = qb @ kf                                     # [B,KH,rep,n,Sk]
        q_pos = q_offset + s0 + torch.arange(n, device=q.device)
        valid = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
        if causal:
            valid &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            valid &= q_pos[:, None] - k_pos[None, :] < window
        s = s.masked_fill(~valid, NEG_INF)
        o = torch.softmax(s, dim=-1) @ vf               # [B,KH,rep,n,hd]
        out[:, s0:s0 + n] = o.reshape(B, H, n, hd).transpose(1, 2) \
            .to(q.dtype)
    return out


# route -> (library, entry point); the f32 routes also take a scratch
ROUTES = {"sm90": ("flash_attention_sm90", "flash_attention_sm90"),
          "tf32": ("flash_attention_tf32", "flash_attention_tf32"),
          "hd256": ("flash_attention_hd256", "flash_attention_hd256_bf16"),
          "hd256_f32": ("flash_attention_hd256_tf32",
                        "flash_attention_hd256_tf32")}
SCRATCH_ROUTES = ("tf32", "hd256_f32")


def _bind(lib, route: str):
    """(entry point, the f32 kernels' scratch size function or None) of
    `route` in its loaded library, argument types set."""
    fn = getattr(lib, ROUTES[route][1])
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    split = route in SCRATCH_ROUTES
    # causal, window, q_offset (and the bf16 route's block_q, block_k)
    flags = 5 if route == "sm90" else 3
    fn.argtypes = ([p] * (5 if split else 4) + [i] * 6 + [i64] * 12
                   + [i] * flags + [ctypes.c_float, p])
    fn.restype = i
    if not split:
        return fn, None
    scratch = getattr(lib, f"{ROUTES[route][1]}_scratch_bytes")
    scratch.argtypes = [i] * 4
    scratch.restype = ctypes.c_longlong
    return fn, scratch


_fns: dict[str, tuple] = {}


def _kernel(route: str):
    """`_bind` of `route`, its library built and loaded once."""
    if route not in _fns:
        _fns[route] = _bind(build.load(ROUTES[route][0]), route)
    return _fns[route]


def route_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes `dtype` at head dim `hd` (a ROUTES key)."""
    if hd <= TC_HEAD_DIM:
        return "sm90" if dtype == torch.bfloat16 else "tf32"
    return "hd256" if dtype == torch.bfloat16 else "hd256_f32"


def block_candidates(seq_q: int, seq_k: int, *,
                     dtype: torch.dtype = torch.bfloat16,
                     hd: int = 128) -> list[tuple[int, int]]:
    """(block_q, block_k) candidates for the tile-size autotuner: the
    shapes the kernel of (`dtype`, `hd`) is built at (`route_for`), in
    the reference's order (block_q, then block_k, ascending), without
    blocks longer than the sequence, as the reference's
    `block_candidates` (the smallest stays). The TPU kernel takes any
    block of its (64..512) x (128..1024) list; these are Hopper's: a
    consumer warpgroup holds 64 query rows, and 227 KB of shared memory
    holds two stages of K and V at 128 keys (csrc/flash_attention_sm90.cu)."""
    shapes = sorted(BLOCK_SHAPES[route_for(dtype, hd)])
    q_min = min(bq for bq, _ in shapes)
    k_min = min(bk for _, bk in shapes)
    return [(bq, bk) for bq, bk in shapes
            if bq <= max(seq_q, q_min) and bk <= max(seq_k, k_min)]


def _block_shape(route: str, block_q: int | None,
                 block_k: int | None) -> tuple[int, int]:
    """The (block_q, block_k) of a call on `route`: None keeps the
    route's default; a shape it is not built at raises, naming them."""
    shapes = BLOCK_SHAPES[route]
    shape = (shapes[0][0] if block_q is None else block_q,
             shapes[0][1] if block_k is None else block_k)
    if shape not in shapes:
        raise ValueError(f"flash_attention: (block_q, block_k) = {shape} "
                         f"is not a shape the {route} kernel is built at: "
                         f"{sorted(shapes)}")
    return shape


def _check_tma(q, k, v) -> None:
    """The bf16 kernels read q, k, v with TMA, which needs 16-byte
    aligned base pointers and strides that are multiples of 16 bytes,
    the head-dim row (hd * 2 bytes) included."""
    hd = q.shape[-1]
    if hd * 2 % 16:
        raise ValueError(f"flash_attention: bf16 head dim {hd} must be a "
                         f"multiple of 8 (TMA: rows of hd * 2 bytes, a "
                         f"multiple of 16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s base pointer is "
                             f"not 16-byte aligned (TMA)")
        if any(s * 2 % 16 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{t.stride()} must be multiples of 8 "
                             f"elements (TMA: multiples of 16 bytes)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KH,hd] (model layout, read through
    their strides; the last axis must be contiguous). f32 or bf16, all
    three alike; hd <= 256 (in bf16 a multiple of 8, and pointers and
    strides as TMA takes them: `_check_tma`); `q_offset` a Python int
    >= 0. (`block_q`, `block_k`): one of the route's `BLOCK_SHAPES`, None
    its default; checked on the CPU too, where the plain version ignores
    it (the output does not depend on it, as the TPU kernel's does not).
    The kernel launches on the tensors' device. Returns [B,Sq,H,hd] in
    q's dtype."""
    B, Sq, Sk, H, KH, hd = _check_shapes(q, k, v)
    build.check_no_grad("flash_attention", "use_pallas_attn", q=q, k=k,
                        v=v)
    # a shape outside the route's is refused on the CPU too
    if block_q is not None or block_k is not None:
        _block_shape(route_for(q.dtype, hd), block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    build.check_one_device("flash_attention", q=q, k=k, v=v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: float32 or bfloat16 expected, "
                         f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} "
                             f"on {q.device}, got {t.dtype} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis must be "
                             f"contiguous, got strides {t.stride()}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"1..{MAX_HEAD_DIM}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be a Python int "
                         f">= 0, got {q_offset!r}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    # the kernel skips key tiles wholly outside the causal window, which
    # is exact for every query row that sees at least one key
    if Sk == 0 or (window is not None and q_offset + Sq - window >= Sk):
        raise ValueError("flash_attention: some query row sees no key "
                         f"(Sk={Sk}, Sq={Sq}, q_offset={q_offset}, "
                         f"window={window})")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_tma(q, k, v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B * Sq * H == 0:
        return out
    route = route_for(q.dtype, hd)
    block = _block_shape(route, block_q, block_k)
    fn, scratch_bytes = _kernel(route)
    # f32: the kernel's K and V^T hi/lo tiles, written by its pre-pass
    scratch = None if scratch_bytes is None else torch.empty(
        scratch_bytes(B, Sk, KH, hd), dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *(() if scratch is None else (scratch.data_ptr(),)),
                 B, Sq, Sk, H, KH, hd, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 int(causal), 0 if window is None else int(window),
                 q_offset, *(block if route == "sm90" else ()),
                 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:         # a CUDA error; bf16 also 10000 (no tensor-map encoder)
        # (30000, no such block shape, cannot come: _block_shape checks)
        raise RuntimeError(f"flash_attention launch failed: error {err}"
                           + (" (20000 + the CUresult of "
                              "cuTensorMapEncodeTiled)" if err >= 20000
                              else ""))
    global launches, launches_tc, launches_f32, launches_hd256, \
        launches_hd256_f32
    launches += 1
    if route == "sm90":
        launches_tc += 1
        launches_sm90[block] += 1
    elif route == "tf32":
        launches_f32 += 1
    elif route == "hd256":
        launches_hd256 += 1
    else:
        launches_hd256_f32 += 1
    return out
