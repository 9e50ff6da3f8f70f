"""The plain versions of the LM zoo's two kernels against the JAX
package's Pallas kernels (interpret mode) and their oracles, on the CPU.

On CPU tensors the wrappers `flash_attention` and `ssd_scan` run these
plain versions (and launch nothing); the CUDA kernels are held against
them on the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances
as the reference's own kernel tests: flash 2e-5 in f32 and 2e-2 in
bf16 (one bf16 rounding of the output), ssd_scan 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan.ops import ssd_scan as jssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels import flash_attention as fa
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
