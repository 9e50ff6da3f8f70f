"""Single-query attention over a key/value cache: the decode step of the
LM zoo's GQA, sliding-window and cross-attention layers.

Replaces no TPU kernel: the reference's `cache_attention`
(`repro.models.layers`) is plain jnp left to XLA. For q [B,1,H,hd] over
a cache k, v [B,C,KH,hd] (kv head h // (H // KH)):

    s[t] = f32(q * scale) . f32(k[:, t])     (q * scale in q's dtype)
    s[t] = -1e30 where k_pos[:, t] < 0, k_pos > pos, or (window)
           pos - k_pos >= window; with k_pos None no slot is masked
    out  = softmax_t(s) @ f32(v), in q's dtype

`decode_attention` launches the hand-written CUDA kernel
`csrc/decode_attention.cu` for CUDA tensors and runs the plain PyTorch
version `decode_attention_plain` for tensors on any other device: the
CPU, and the meta tensors of the dry-run lowering
(`launch.lowering`), which counts the plain version's operations, as
the reference's. A CUDA tensor the kernel does not take raises (no
fallback).
`launches` counts kernel launches (a split call's merge kernel too).
Neither route has a backward, and both refuse inputs that require grad
while grad mode is on (`build.check_no_grad`).

Why it was added: the plain version upcasts the whole cache to f32 and
each einsum copies its operand once more, which took ~75 % of
musicgen-large's decode step on an H100 (PERF.md). What bounds the
kernel is bytes: one read of the slots that can hold a visible key, in
the cache's dtype, 2 * n * hd * itemsize a (row, kv head). It reads
slots [0, n) alone, n = min(pos + 1, C) with k_pos and C without: a full
cache writes position p at slot p and a ring at p % C
(`layers.attn_apply_decode`, `attn_make_cache_from_prefill`), so no slot
at or beyond n holds a visible key. It splits a (row, kv head)'s slots
over blocks only where the rows and kv heads alone would cover the
card's SMs less than twice (`plan`), and then merges the splits in a
second launch (PERF.md §6 times the plan against one split a (row, kv
head) at batch 4).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

launches = 0
NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_REP_HD = 4096       # rep * hd: the f32 accumulators a block holds
STAGE_BYTES = 36864     # K and V of one tile in shared memory, at most


def _check_shapes(q, k_cache, v_cache, k_pos) -> tuple[int, ...]:
    if (q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4
            or k_cache.shape != v_cache.shape):
        raise ValueError(f"decode_attention: q [B,1,H,hd] and k, v "
                         f"[B,C,KH,hd] expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, hd = q.shape
    C, KH = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != hd or KH == 0
            or H % KH):
        raise ValueError(f"decode_attention: k/v {tuple(k_cache.shape)} do "
                         f"not fit q {tuple(q.shape)} (H % KH must be 0)")
    if k_pos is not None and tuple(k_pos.shape) != (B, C):
        raise ValueError(f"decode_attention: k_pos [B,C] = {(B, C)} "
                         f"expected, got {tuple(k_pos.shape)}")
    return B, H, KH, hd, C


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_pos: torch.Tensor | None,
                           pos: int, *,
                           window: int | None = None) -> torch.Tensor:
    """q [B,1,H,hd] over the cache [B,C,KH,hd]: the function above over
    all C slots, as the reference writes it."""
    B, H, KH, hd, C = _check_shapes(q, k_cache, v_cache, k_pos)
    rep = H // KH
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)
    qh = (q * scale).reshape(B, KH, rep, hd)
    s = torch.einsum("bgrd,btgd->bgrt", qh.float(), k_cache.float())
    if k_pos is not None:
        valid = (k_pos >= 0) & (k_pos <= pos)
        if window is not None:
            valid = valid & (pos - k_pos < window)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def read_slots(C: int, k_pos, pos: int) -> int:
    """n: the kernel reads slots [0, n) of a cache of C slots."""
    return min(pos + 1, C) if k_pos is not None else C


def tile_slots(hd: int, itemsize: int) -> int:
    """Slots of one K/V tile in shared memory: 64, halved while K and V
    of a tile, their rows padded to an odd number of 16-byte units (no
    bank conflicts), take more than STAGE_BYTES."""
    vec = 16 // itemsize
    pitch = hd + vec if (hd // vec) % 2 == 0 else hd
    tile = 64
    while tile > 8 and 2 * tile * pitch * itemsize > STAGE_BYTES:
        tile //= 2
    return tile


def plan(bkh: int, n: int, tile: int, sms: int = 132) -> tuple[int, int]:
    """(splits, slots a split) for B * KH = `bkh` blocks of work over `n`
    slots read in tiles of `tile` on a card of `sms` SMs: enough splits
    that the blocks cover the SMs about twice (one split, and one
    launch, at bkh >= 2 * sms), each a whole number of tiles but the
    last, none empty."""
    want = -(-2 * sms // bkh)
    chunk = min(n, -(-n // (want * tile)) * tile)
    return -(-n // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scale(dtype: torch.dtype, hd: int) -> float:
    """1/sqrt(hd) rounded to `dtype`, as the plain version multiplies."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dtype))


_fn = None


def _kernel():
    """The kernel's entry point, its library built and loaded once."""
    global _fn
    if _fn is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn = build.load("decode_attention").decode_attention
        fn.argtypes = ([p] * 6 + [i] * 11 + [ctypes.c_float] + [i64] * 10
                       + [p])
        fn.restype = i
        _fn = fn
    return _fn


def _check_card(q, k_cache, v_cache, k_pos, rep, hd) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: float32 or bfloat16 expected, "
                         f"got {q.dtype}")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if rep * hd > MAX_REP_HD:
        raise ValueError(f"decode_attention: {rep} query heads a kv head "
                         f"at hd {hd} exceed rep * hd = {MAX_REP_HD}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} must be {q.dtype}, "
                             f"got {t.dtype}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             f"last axis, a 16-byte aligned pointer and "
                             f"strides of whole 16 bytes (16-byte copies), "
                             f"got strides {t.stride()}")
    if q.stride(3) != 1:
        raise ValueError(f"decode_attention: q's last axis must be "
                         f"contiguous, got strides {q.stride()}")
    if k_pos is not None and k_pos.dtype != torch.int32:
        raise ValueError(f"decode_attention: k_pos must be int32, got "
                         f"{k_pos.dtype}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_pos: torch.Tensor | None,
                     pos: int, *,
                     window: int | None = None) -> torch.Tensor:
    """q [B,1,H,hd] over the cache k_cache, v_cache [B,C,KH,hd] (read
    through their strides); k_pos [B,C] int32 absolute positions of the
    cached keys (-1 an empty slot), or None where every slot is seen (a
    cross-attention cache); pos: the query's position, a Python int.
    On the card: f32 or bf16 alike, hd a multiple of 8 up to 256,
    rep * hd <= 4096; the kernel launches on the tensors' device.
    Elsewhere the plain version. Returns [B,1,H,hd] in q's dtype."""
    B, H, KH, hd, C = _check_shapes(q, k_cache, v_cache, k_pos)
    build.check_no_grad("decode_attention", q=q, k_cache=k_cache,
                        v_cache=v_cache)
    if q.device.type != "cuda":
        return decode_attention_plain(q, k_cache, v_cache, k_pos, pos,
                                      window=window)
    extra = {} if k_pos is None else {"k_pos": k_pos}
    build.check_one_device("decode_attention", q=q, k_cache=k_cache,
                           v_cache=v_cache, **extra)
    rep = H // KH
    _check_card(q, k_cache, v_cache, k_pos, rep, hd)
    if not isinstance(pos, int) or pos < 0:
        raise ValueError(f"decode_attention: pos must be a Python int >= 0, "
                         f"got {pos!r}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window must be >= 1, got "
                         f"{window}")
    n = read_slots(C, k_pos, pos)
    if n == 0 or B == 0:
        raise ValueError(f"decode_attention: nothing to attend to (B={B}, "
                         f"C={C})")
    tile = tile_slots(hd, q.element_size())
    splits, chunk = plan(B * KH, n, tile, _sm_count(q.device.index))
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part = (torch.empty(B * KH * splits * rep * (hd + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    kp = (0, 0) if k_pos is None else k_pos.stride()
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            int(q.dtype == torch.bfloat16), B, KH, rep, hd, n, splits,
            chunk, tile, pos, 0 if window is None else int(window),
            _scale(q.dtype, hd), q.stride(0), q.stride(2),
            *k_cache.stride()[:3], *v_cache.stride()[:3], *kp,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1 + (splits > 1)
    return out
