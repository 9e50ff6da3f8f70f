"""The plain versions of the LM zoo's two kernels against the JAX
package's Pallas kernels (interpret mode) and their oracles, on the CPU.

On CPU tensors the wrappers `flash_attention` and `ssd_scan` run these
plain versions (and launch nothing); the CUDA kernels are held against
them on the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances
as the reference's own kernel tests: flash 2e-5 in f32 and 2e-2 in
bf16 (one bf16 rounding of the output), ssd_scan 1e-5. The card kernels'
own rounding (bf16: P split into bf16 halves; f32: split-TF32 products)
is emulated here and held to the card's element-wise limits.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan.ops import ssd_scan as jssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import graph_aggregate as ga
from repro_torch.kernels import segment_aggregate as sa
from repro_torch.kernels import ssd_scan as ss

# (B, Sq, Sk, H, KH, hd, causal, window, q_offset, dtype): the six
# FLASH_CASES of tests/test_kernels.py (Sq = Sk, q_offset 0), then the
# model's head dim 120, and int q_offsets with Sq < Sk
FLASH_CASES = [
    (1, 64, 64, 2, 2, 32, True, None, 0, "float32"),
    (2, 128, 128, 4, 2, 64, True, None, 0, "float32"),
    (1, 96, 96, 4, 1, 32, True, 32, 0, "float32"),        # MQA + SWA
    (2, 64, 64, 8, 2, 16, False, None, 0, "float32"),
    (1, 128, 128, 2, 2, 64, True, 64, 0, "bfloat16"),
    (1, 80, 80, 3, 3, 48, True, None, 0, "float32"),      # ragged edges
    (2, 72, 72, 4, 1, 120, True, 40, 0, "float32"),       # hd 120, GQA 4
    (1, 24, 64, 4, 2, 32, True, None, 40, "float32"),     # q_offset
    (2, 40, 96, 4, 2, 120, True, 24, 56, "bfloat16"),     # + window
]


def _flash_inputs(B, Sq, Sk, H, KH, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Sk, KH, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Sk, KH, hd)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_plain_matches_pallas_and_oracle(case):
    B, Sq, Sk, H, KH, hd, causal, window, q_offset, dtype = case
    q, k, v = _flash_inputs(B, Sq, Sk, H, KH, hd, dtype, seed=Sq * hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    pallas = jflash(jq, jk, jv, causal=causal, window=window,
                    q_offset=q_offset, block_q=32, block_k=32,
                    interpret=True)
    oracle = attention_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                           jv.transpose(0, 2, 1, 3), causal=causal,
                           window=window, q_offset=q_offset
                           ).transpose(0, 2, 1, 3)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    before = fa.launches
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_offset=q_offset)
    assert fa.launches == before            # CPU tensors: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, fa.flash_attention_plain(
        tq, tk, tv, causal=causal, window=window, q_offset=q_offset))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_attention_plain_blocks_query_rows():
    """The plain version's blocking over query rows changes nothing but
    the matmul's rounding (PyTorch's CPU matmul may sum a row in another
    order when the row count differs): 1e-6."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(
        1, 1100, 1100, 2, 1, 16, "float32", seed=7))
    got = fa.flash_attention_plain(q, k, v, causal=True, window=300)
    one = fa.flash_attention_plain(q[:, 600:601], k, v, causal=True,
                                   window=300, q_offset=600)
    torch.testing.assert_close(got[:, 600:601], one, rtol=1e-6, atol=1e-6)


def test_flash_attention_rejects_mismatched_shapes():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="H % KH"):
        fa.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                           torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="expected"):
        fa.flash_attention(q, torch.zeros((1, 8, 2, 16)),
                           torch.zeros((1, 9, 2, 16)))


# ---------------------------------------------- the bf16 kernel's rounding
# The card's bf16 kernel (csrc/flash_attention_sm90.cu) cannot run here.
# What it changes in the arithmetic can: bf16 operands with f32 sums in
# the tensor cores, the scale applied to the f32 score after q . k, a
# tiled online softmax, P split into bf16 halves for P . V, whose k16
# steps the tensor cores add into an f32 accumulator rounding toward zero
# (`_rz_float32`), a fresh one per key tile folded in as O·alpha + O_t.
# The emulation below does exactly that, and is held to the limit the
# card's checks use (chip_smoke.py FLASH_TOL, tests/test_torch_cuda.py).
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -6, 1e-5


def _emulate_tensor_core_flash(q, k, v, *, causal, window, q_offset,
                               tile=128, split_p=True, fresh_pv=True):
    """q [B,Sq,H,hd], k, v [B,Sk,KH,hd] in bf16 -> bf16, in the rounding
    of the bf16 kernel: key tiles of `tile`, running (m, l, O) in f32,
    P . V as bf16(p) . V + bf16(p - bf16(p)) . V (or, with `split_p`
    False, bf16(p) . V alone, the usual flash kernel's rounding), its k16
    steps added toward zero into a fresh accumulator folded in as
    O·alpha + O_t in one rounding (or, with `fresh_pv` False, into O
    carried across the row, as the kernel once did)."""
    B, Sq, H, hd = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # [B,H,Sq,hd]
    kf = k.float().repeat_interleave(rep, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, 2).transpose(1, 2)
    q_pos = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), fa.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = (qf @ kt.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        k_pos = k0 + torch.arange(kt.shape[2])[None, :]
        valid = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            valid &= k_pos <= q_pos
        if window is not None:
            valid &= q_pos - k_pos < window
        s = s.masked_fill(~valid, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        terms = [p_hi] + ([(p - p_hi).bfloat16().float()] if split_p
                          else [])
        acc = torch.zeros_like(o) if fresh_pv else o * alpha
        for k16 in range(0, kt.shape[2], 16):
            for t in terms:
                acc = _rz_float32(acc.double() + t[..., k16:k16 + 16].double()
                                  @ vt[..., k16:k16 + 16, :].double())
        o = ((o.double() * alpha.double() + acc.double()).float()
             if fresh_pv else acc)
        m = m_new
    return (o / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


def _bf16_worst(case, split_p):
    """The emulation's largest |Δ| / (rtol·|ref| + atol) against the
    plain version, and the share of elements over the limit."""
    B, Sq, Sk, H, KH, hd, causal, window, q_offset, tile = case
    q, k, v = (_torch(a, "bfloat16") for a in _flash_inputs(
        B, Sq, Sk, H, KH, hd, "bfloat16", seed=Sk + hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_tensor_core_flash(q, k, v, tile=tile, split_p=split_p,
                                     **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw).float()
    ratio = (got.float() - ref).abs() / (FLASH_BF16_RTOL * ref.abs()
                                         + FLASH_BF16_ATOL)
    return float(ratio.max()), float((ratio > 1).float().mean())


# (B, Sq, Sk, H, KH, hd, causal, window, q_offset, key tile): hd 120
# (the model's), 128 and 64, causal or not, a window or none, at the
# kernel's 128-key tiles; then q_offset > 0 with Sq < Sk at 64-key tiles;
# then the hd-256 kernel (csrc/flash_attention_hd256.cu: the same
# arithmetic over 64-key tiles) at hd 256 (recurrentgemma-9b's), 192 and
# 136, causal or not, a window or none, and q_offset > 0 with Sq < Sk
FLASH_BF16_EMU_CASES = [
    (1, 256, 256, 4, 1, hd, causal, window, 0, 128)
    for hd in (120, 128, 64) for causal in (True, False)
    for window in (None, 100)] + [
    (1, 96, 320, 4, 2, hd, True, 150, 224, 64) for hd in (120, 128, 64)] + [
    (1, 256, 256, 2, 1, hd, True, window, 0, 64)
    for hd in (256, 192, 136) for window in (None, 100)] + [
    (1, 200, 200, 2, 1, 256, False, 70, 0, 64)] + [
    (1, 96, 320, 4, 1, hd, True, 150, 224, 64) for hd in (256, 192, 136)]


@pytest.mark.parametrize("case", FLASH_BF16_EMU_CASES, ids=str)
def test_flash_attention_bf16_kernel_rounding_within_flash_tol(case):
    """With P split into bf16 halves the kernel's rounding stays within
    2^-6·|ref| + 1e-5 of the plain version (one bf16 ulp of the output,
    at most 2^-7·|ref|, is half of that: 0.46-0.50 of the limit here)."""
    worst, _ = _bf16_worst(case, split_p=True)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("hd,sigma,tile", [(128, 1.7, 128), (256, 2.0, 64)],
                         ids=["hd128", "hd256"])
def test_flash_attention_bf16_pv_carried_across_tiles_fails_flash_tol(
        hd, sigma, tile):
    """The guard on the fresh P . V accumulator: late rows of an S = 8192
    causal head with q, k, v ~ N(0, sigma^2) (llava-next-34b's layer-0
    scale: a peaked softmax over large v), whose outputs cancel to near 0
    here and there. P . V carried across the row in the truncating
    accumulator puts some of them past 2^-6·|ref| + 1e-5; folded per key
    tile they stay at the output's own rounding. At hd 128 (the hd <= 128
    kernel's 128-key tiles) sigma 1.7 puts one element over; at hd 256
    (the hd-256 kernel's 64-key tiles) sigma 1.7 leaves this seed's
    carried accumulator inside the limit, sigma 2.0 does not."""
    S, q0 = 8192, 6144
    g = torch.Generator().manual_seed(3)
    q, k, v = ((torch.randn(1, S, 1, hd, generator=g) * sigma).bfloat16()
               for _ in range(3))
    q = q[:, q0:]
    kw = dict(causal=True, window=None, q_offset=q0)
    ref = fa.flash_attention_plain(q, k, v, **kw).float()
    worst = []
    for fresh in (False, True):
        got = _emulate_tensor_core_flash(q, k, v, fresh_pv=fresh, tile=tile,
                                         **kw)
        worst.append(float(((got.float() - ref).abs()
                             / (FLASH_BF16_RTOL * ref.abs()
                                + FLASH_BF16_ATOL)).max()))
    assert worst[0] > 1.0 and worst[1] <= 0.55, worst


def test_flash_attention_bf16_p_rounded_once_fails_flash_tol():
    """The guard on the split: P rounded to bf16 once, as a usual flash
    kernel does, fails the same limit at hd = 120 with a window (49.5x
    the limit, 4.8 % of the elements over it)."""
    case = (1, 256, 256, 4, 1, 120, True, 100, 0, 128)
    worst, share = _bf16_worst(case, split_p=False)
    assert worst > 10.0 and share > 0.01, (worst, share)
    assert _bf16_worst(case, split_p=True)[0] <= 1.0


# ----------------------------------------------- the f32 kernel's rounding
# The card's f32 kernel (csrc/flash_attention_tf32.cu) takes both
# products on the tensor cores in split TF32: a = hi + lo, hi = rna(a),
# lo = rna(a - hi), a·b = hi·lo + lo·hi + hi·hi, over 64-key tiles. The
# emulation below repeats that arithmetic: tf32 rounding as the kernel's
# integer operations, each k8 step of 8 products summed exactly and
# truncated toward zero into the f32 accumulator (a model of the tensor
# cores' rounding, the less favourable of round-to-nearest and
# truncation), the two small correction terms first and the hi·hi steps on
# top, P·V of each tile into a fresh accumulator folded in as O·alpha +
# Ot. It is held to the card's f32 limit (chip_smoke.py FLASH_TOL).
FLASH_F32_RTOL, FLASH_F32_ATOL = 2e-5, 5e-6


def _tf32_rna(x):
    """float32 -> tf32 as the kernel's tf32_rna: 10 explicit mantissa
    bits, ties away from zero, as two integer operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rz_float32(x):
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _tc_product(a, b, split, chunk=None):
    """a [..., M, D] @ b[..., N, D]^T as the tensor cores take it: k8
    steps into an f32 accumulator, truncated after each; `split`: the
    three-term split TF32 (corrections first), else one tf32 product.
    `chunk`: D is cut into chunks of that many columns, each summed in a
    fresh accumulator, and the chunks' sums are added in f32 (round to
    nearest); None: one accumulator over all of D."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    terms = []
    if split:
        a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
        terms = [(a_hi, b_lo), (a_lo, b_hi)]
    terms.append((a_hi, b_hi))
    D = a.shape[-1]
    total = None
    for c0 in range(0, D, chunk or D):
        acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32)
        for x, y in terms:
            for k0 in range(c0, min(D, c0 + (chunk or D)), 8):
                step = (x[..., k0:k0 + 8].double()
                        @ y[..., k0:k0 + 8].double().transpose(-1, -2))
                acc = _rz_float32(acc.double() + step)
        total = acc if total is None else total + acc
    return total


def _emulate_split_tf32_flash(q, k, v, *, causal, window, q_offset,
                              tile=64, split=(True, True), qk_chunk=None):
    """q [B,Sq,H,hd], k, v [B,Sk,KH,hd] f32 -> f32 in the arithmetic of
    the f32 kernels, over key tiles of `tile`; `split` (Q·K^T, P·V): False
    takes that product as one tf32 product instead; `qk_chunk`: Q·K^T's
    head-dim columns per fresh accumulator (`_tc_product`'s `chunk`)."""
    B, Sq, H, hd = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]
    qs = (q * (1.0 / math.sqrt(hd))).transpose(1, 2)        # [B,H,Sq,hd]
    kf = k.repeat_interleave(rep, 2).transpose(1, 2)
    vt = v.repeat_interleave(rep, 2).permute(0, 2, 3, 1)    # [B,H,hd,Sk]
    q_pos = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), fa.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, tile):
        s = _tc_product(qs, kf[:, :, k0:k0 + tile], split[0], qk_chunk)
        k_pos = k0 + torch.arange(s.shape[-1])[None, :]
        valid = k_pos < Sk
        if causal:
            valid = valid & (k_pos <= q_pos)
        if window is not None:
            valid = valid & (q_pos - k_pos < window)
        s = s.masked_fill(~valid, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = torch.addcmul(_tc_product(p, vt[..., k0:k0 + tile], split[1]),
                          o, alpha)
        m = m_new
    return (o / l.clamp_min(1e-30)).transpose(1, 2)


def _f32_worst(case, split=(True, True), **emu):
    """The emulation's largest |Δ| / (rtol·|ref| + atol) against the
    plain version; `emu`: the emulation's tile and qk_chunk."""
    B, Sq, Sk, H, KH, hd, causal, window, q_offset, qmul = case
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(
        B, Sq, Sk, H, KH, hd, "float32", seed=Sk + hd))
    q = q * qmul
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_split_tf32_flash(q, k, v, split=split, **emu, **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    return float(((got - ref).abs() / (FLASH_F32_RTOL * ref.abs()
                                       + FLASH_F32_ATOL)).max())


# (B, Sq, Sk, H, KH, hd, causal, window, q_offset, q scale): hd 120 (the
# model's), 128 and 64, a window or none; q_offset > 0 with Sq < Sk; and
# q x 3, where the scores are larger and exp turns their error into most
# of the output's
FLASH_F32_EMU_CASES = [
    (1, 256, 256, 4, 1, hd, True, window, 0, 1.0)
    for hd in (120, 128, 64) for window in (None, 100)] + [
    (1, 96, 320, 4, 2, hd, True, 150, 224, 1.0) for hd in (120, 128, 64)] + [
    (1, 256, 256, 4, 1, 120, True, 100, 0, 3.0),
    (1, 256, 256, 4, 2, 128, True, None, 0, 3.0),
    (1, 96, 320, 4, 2, 64, True, 150, 224, 3.0)]


@pytest.mark.parametrize("case", FLASH_F32_EMU_CASES, ids=str)
def test_flash_attention_f32_kernel_split_tf32_within_flash_tol(case):
    """Split TF32 on both products stays within 2e-5·|ref| + 5e-6 of the
    plain version, q x 3 included."""
    assert _f32_worst(case) <= 1.0


@pytest.mark.parametrize("split", [(False, True), (True, False)],
                         ids=["qk-one-product", "pv-one-product"])
def test_flash_attention_f32_one_tf32_product_fails_flash_tol(split):
    """The guard on the split: one tf32 product on either side, the other
    split, fails the same limit by more than 10x."""
    case = (1, 256, 256, 4, 1, 120, True, 100, 0, 1.0)
    assert _f32_worst(case, split) > 10.0
    assert _f32_worst(case) <= 1.0


# The hd-256 f32 kernel (csrc/flash_attention_hd256_tf32.cu) takes the
# same split-TF32 arithmetic over 32-key tiles, with Q·K^T's head-dim sum
# in fresh accumulators of 64 columns each, added in f32: one accumulator
# carried over all 256 columns truncates 96 k8 steps into one running
# sum, which fails the limit at q x 3. Cases (as above): hd 256 (the
# model's), 192 and 136 (past 128, one k8 step into the third chunk),
# q x 1 and q x 3, a window or none, and q_offset > 0 with Sq < Sk.
HD256_EMU = dict(tile=32, qk_chunk=64)
FLASH_HD256_F32_EMU_CASES = [
    (1, 256, 256, 2, 1, hd, True, window, 0, qmul)
    for hd in (256, 192, 136) for window in (None, 100)
    for qmul in (1.0, 3.0)] + [
    (1, 96, 320, 2, 1, hd, True, 150, 224, 3.0) for hd in (256, 192)]


@pytest.mark.parametrize("case", FLASH_HD256_F32_EMU_CASES, ids=str)
def test_flash_attention_hd256_f32_split_tf32_within_flash_tol(case):
    """The hd-256 kernel's arithmetic stays within 2e-5·|ref| + 5e-6 of
    the plain version at hd 256, 192 and 136, q x 3 included."""
    assert _f32_worst(case, **HD256_EMU) <= 1.0


def test_flash_attention_hd256_f32_one_accumulator_fails_flash_tol():
    """The guard on the head-dim chunks: the same q x 3 input at hd 256
    with one accumulator over all 256 columns of Q·K^T fails the limit
    (1.40x it), the chunked sum passes."""
    case = (1, 256, 256, 2, 1, 256, True, None, 0, 3.0)
    assert _f32_worst(case, tile=32) > 1.0
    assert _f32_worst(case, **HD256_EMU) <= 1.0


def test_tf32_rna_rounds_to_nearest_ties_away():
    """The integer rounding keeps 10 explicit mantissa bits, ties away
    from zero, and leaves hi + lo within 2^-22 of the value."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0])
    assert _tf32_rna(x).tolist() == [1.0 + 2.0 ** -10,
                                     -(1.0 + 2.0 ** -10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, 4096).astype(np.float32))
    hi = _tf32_rna(y)
    lo = _tf32_rna(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -22


SSD_CASES = [(1, 2, 1, 8, 8), (2, 4, 3, 16, 8), (1, 8, 5, 32, 16),
             (2, 16, 2, 64, 32)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_plain_matches_pallas_and_oracle(case):
    B, nc, H, N, P = case
    rng = np.random.default_rng(nc * N)
    S = rng.normal(0, 1, (B, nc, H, N, P)).astype(np.float32)
    d = rng.uniform(0.05, 0.999, (B, nc, H)).astype(np.float32)
    before = ss.launches
    hb, hf = ss.ssd_scan(torch.from_numpy(S), torch.from_numpy(d))
    assert ss.launches == before
    assert hb.dtype == hf.dtype == torch.float32
    for want_b, want_f in (jssd(jnp.asarray(S), jnp.asarray(d),
                                interpret=True),
                           ssd_scan_ref(jnp.asarray(S), jnp.asarray(d))):
        np.testing.assert_allclose(hb.numpy(), np.asarray(want_b),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_f),
                                   rtol=1e-5, atol=1e-5)


def test_ssd_scan_first_chunk_state_is_zero():
    hb, hf = ss.ssd_scan(torch.ones((1, 3, 1, 4, 4)),
                         torch.full((1, 3, 1), 0.5))
    assert float(hb[:, 0].abs().max()) == 0.0
    assert torch.equal(hb[:, 1], torch.ones((1, 1, 4, 4)))
    assert torch.equal(hf, torch.full((1, 1, 4, 4), 1.75))


def test_ssd_scan_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="expected"):
        ss.ssd_scan(torch.zeros((1, 3, 2, 4, 4)), torch.zeros((1, 3, 1)))


# ------------------------------------------------ block shapes (autotuner)
# (B, S, H, KH, hd, window, dtype, (block_q, block_k)): each shape a
# route's kernel is built at, its Pallas twin run at the same blocks
BLOCK_CASES = [
    (1, 160, 4, 2, 120, 40, "bfloat16", bk) for bk in
    ((128, 128), (128, 64), (64, 128), (64, 64))] + [
    (2, 96, 4, 2, 64, None, "float32", (64, 64)),
    (1, 80, 2, 1, 256, 48, "bfloat16", (128, 64)),
    (1, 80, 2, 1, 256, None, "float32", (64, 32))]


def test_flash_block_candidates_per_route():
    """bf16 hd <= 128 lists the four instantiations in the reference's
    order, the other routes their one shape; blocks longer than the
    sequence drop out as in the reference (the smallest stays)."""
    every = [(64, 64), (64, 128), (128, 64), (128, 128)]
    assert fa.block_candidates(4096, 4096) == every
    assert fa.block_candidates(128, 128, hd=64) == every
    assert fa.block_candidates(100, 4096) == [(64, 64), (64, 128)]
    assert fa.block_candidates(4096, 100) == [(64, 64), (128, 64)]
    assert fa.block_candidates(8, 8) == [(64, 64)]
    assert fa.block_candidates(4096, 4096, dtype=torch.float32) == [(64, 64)]
    assert fa.block_candidates(4096, 4096, hd=256) == [(128, 64)]
    assert fa.block_candidates(4096, 4096, dtype=torch.float32,
                               hd=256) == [(64, 32)]
    assert fa.block_candidates(16, 16, hd=256) == [(128, 64)]
    for route, shapes in fa.BLOCK_SHAPES.items():
        assert len(set(shapes)) == len(shapes) and route in fa.ROUTES


@pytest.mark.parametrize("dtype,hd,block", [
    ("bfloat16", 128, (256, 128)), ("bfloat16", 64, (128, 256)),
    ("bfloat16", 120, (512, 512)), ("float32", 64, (128, 128)),
    ("bfloat16", 256, (128, 128)), ("float32", 256, (64, 64))])
def test_flash_refuses_block_shape_outside_the_route(dtype, hd, block):
    """On the CPU too, before the plain version: a shape the route's
    kernel is not built at raises a ValueError that names them."""
    q = torch.zeros((1, 8, 2, hd), dtype=getattr(torch, dtype))
    with pytest.raises(ValueError, match="is not a shape") as e:
        fa.flash_attention(q, q, q, block_q=block[0], block_k=block[1])
    route = fa.route_for(q.dtype, hd)
    assert str(sorted(fa.BLOCK_SHAPES[route])) in str(e.value)


def test_flash_block_shape_defaults_and_halves():
    """None keeps the route's default; one side given takes the default
    of the other; the plain version's output does not depend on it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _flash_inputs(
        1, 70, 70, 4, 2, 64, "bfloat16", seed=5))
    want = fa.flash_attention(q, k, v, causal=True)
    for bq, bk in ((64, None), (None, 64), (128, 128), (64, 64)):
        assert torch.equal(fa.flash_attention(q, k, v, causal=True,
                                              block_q=bq, block_k=bk), want)
    with pytest.raises(ValueError, match="is not a shape"):
        fa.flash_attention(q, k, v, block_q=32)
    assert fa._block_shape("sm90", None, None) == (128, 128)
    assert fa._block_shape("sm90", 64, None) == (64, 128)
    assert fa._block_shape("tf32", None, None) == (64, 64)


@pytest.mark.parametrize("case", BLOCK_CASES, ids=str)
def test_flash_block_shapes_match_pallas(case):
    """The port at each of its candidates against the Pallas kernel
    (interpret mode) run at the same (block_q, block_k), causal; as
    above, 2e-2 in bf16 and 2e-5 in f32."""
    B, S, H, KH, hd, window, dtype, (bq, bk) = case
    q, k, v = _flash_inputs(B, S, S, H, KH, hd, dtype, seed=S + hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    pallas = jflash(jq, jk, jv, causal=True, window=window, block_q=bq,
                    block_k=bk, interpret=True)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True, window=window,
                             block_q=bq, block_k=bk)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol)


def test_kernel_candidate_hooks():
    """graph_aggregate: the Hopper kernel's one 64-channel F-tile at any
    width; segment_aggregate: no edge block, the whole capacity; ssd_scan:
    the reference's lists."""
    for hidden in (16, 48, 192, 1024):
        assert ga.block_candidates(hidden) == [64]
    for cap in (64, 200, 4096):
        assert sa.block_candidates(cap) == [cap]
    for dims in ((128, 64), (16, 8)):
        assert ss.block_candidates(*dims) == jssd_ops.block_candidates(*dims)
    for seq in (64, 100, 256, 768, 2048, 8192):
        assert ss.chunk_candidates(seq) == jssd_ops.chunk_candidates(seq)
