"""The port's RG-LRU mixer and recurrentgemma-9b (repro_torch.models)
against the JAX reference (repro.models), on the CPU at smoke size, and
the flash kernel's plain version at recurrentgemma-9b's head dim 256.

The reference's params cross with `lm_from_jax_params`; inputs come from
numpy. With `use_pallas_attn` the reference runs its Pallas kernel in
interpret mode and the port the flash kernel's plain version. f32
tolerance: 1e-5, as tests/test_torch_lm.py.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.models.params import lm_from_jax_params

ARCH = "recurrentgemma-9b"
B, S = 2, 33            # odd: the scan's recursion meets odd lengths
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _numpy(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def _cache_leaves(cache):
    return [(f"{si}/{ei}/{k}", _numpy(elem[k]))
            for si, stack in enumerate(cache)
            for ei, elem in enumerate(stack) for k in sorted(elem)]


def _hold_cache(got, want, tol=TOL):
    got, want = _cache_leaves(got), _cache_leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if name.endswith("k_pos"):
            assert np.array_equal(a, b), name
        else:
            _close(a, b, tol)


@pytest.fixture(scope="module")
def case():
    cfg = jreg.get_smoke_config(ARCH)
    jparams = jlm.init_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = {}
    for flag in (False, True):
        c = dataclasses.replace(cfg, use_pallas_attn=flag)

        @jax.jit
        def fwd(p, t):
            x = jlm._embed_inputs(p, c, {"tokens": t})
            logits = jlm.logits_fn(p, c, jlm.forward_trunk(p, c, x))
            return logits, jlm.loss_fn(p, c, {"tokens": t})
        ref[flag] = _np(fwd(jparams, jnp.asarray(tokens)))
    pos = S - 1
    p_logits, cache = jax.jit(jlm.prefill_step_fn(cfg, capacity=pos + 1))(
        jparams, {"tokens": jnp.asarray(tokens[:, :pos])})
    ref["prefill"] = _np((p_logits, cache))
    d_logits, cache = jax.jit(jlm.decode_step_fn(cfg))(
        jparams, cache, jnp.asarray(tokens[:, pos:]),
        jnp.asarray(pos, jnp.int32))
    ref["decode"] = _np((d_logits, cache))
    params = lm_from_jax_params(_np(jparams), registry.get_smoke_config(ARCH),
                                device="cpu")
    return params, tokens, ref


@pytest.mark.parametrize("flag", [False, True],
                         ids=["chunked", "flash_kernel"])
def test_forward_and_loss_match_reference(case, flag):
    params, tokens, ref = case
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                              use_pallas_attn=flag)
    batch = {"tokens": torch.from_numpy(tokens)}
    x = lm._embed_inputs(params, cfg, batch)
    logits = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
    loss = lm.loss_fn(params, cfg, batch)
    want_logits, want_loss = ref[flag]
    assert logits.shape == (B, S, cfg.vocab_size)
    _close(logits, want_logits)
    _close(loss, want_loss)


def test_prefill_and_decode_match_reference(case):
    """Prefill on 32 tokens, then decode the 33rd: the logits and every
    cache leaf (the RG-LRU's state and conv, the local attention's ring),
    its dtype included."""
    params, tokens, ref = case
    cfg = registry.get_smoke_config(ARCH)
    pos = S - 1
    p_logits, cache = lm.prefill_step_fn(cfg, capacity=pos + 1)(
        params, {"tokens": torch.from_numpy(tokens[:, :pos])})
    want_logits, want_cache = ref["prefill"]
    _close(p_logits, want_logits)
    _hold_cache(cache, want_cache)
    d_logits, cache = lm.decode_step_fn(cfg)(
        params, cache, torch.from_numpy(tokens[:, pos:]), pos)
    want_logits, want_cache = ref["decode"]
    _close(d_logits, want_logits)
    _hold_cache(cache, want_cache)


def test_prefill_decode_matches_own_forward():
    cfg = registry.get_smoke_config(ARCH)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)))
    x = lm._embed_inputs(params, cfg, {"tokens": tokens})
    want = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
    _, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :-1]})
    got, _ = lm.decode_step_fn(cfg)(params, cache, tokens[:, -1:], S - 1)
    _close(got[:, 0], want[:, -1])


# ------------------------------------------------------------ RG-LRU alone
def _layer_params(seed=4):
    cfg = jreg.get_smoke_config(ARCH)
    jp = JL.rglru_init(jax.random.key(seed), cfg)
    return cfg, jp, {k: torch.from_numpy(np.array(v)) for k, v in
                     _np(jp).items()}


@pytest.mark.parametrize("carried", [False, True],
                         ids=["zero_state", "carried_state"])
def test_rglru_core_matches_reference(carried):
    """y, the new conv state and h at the last step, with and without a
    carried conv state and h0 (h0 folds into the first step)."""
    cfg, jp, tp = _layer_params()
    rng = np.random.default_rng(5)
    W = cfg.rglru.lru_width
    x = rng.normal(size=(B, 21, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(B, cfg.rglru.conv_width - 1, W)) \
        .astype(np.float32) if carried else None
    h0 = rng.normal(size=(B, W)).astype(np.float32) if carried else None
    want = _np(JL.rglru_core(jp, cfg, jnp.asarray(x),
                             None if conv is None else jnp.asarray(conv),
                             None if h0 is None else jnp.asarray(h0)))
    got = L.rglru_core(tp, registry.get_smoke_config(ARCH),
                       torch.from_numpy(x),
                       None if conv is None else torch.from_numpy(conv),
                       None if h0 is None else torch.from_numpy(h0))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33, 64, 100])
def test_assoc_scan_combines_in_the_reference_order(n):
    """The odd/even recursion against `jax.lax.associative_scan` of the
    same combine, at even and odd lengths: within f32 rounding (1e-6)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = rng.normal(size=(2, n, 5)).astype(np.float32)

    def combine(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]
    wa, wb = _np(jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                    jnp.asarray(b)), axis=1))
    ga, gb = L._assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(ga, wa, 1e-6)
    _close(gb, wb, 1e-6)


def test_rglru_bf16_cache_dtypes():
    """bf16 recurrentgemma: `init_cache`'s RG-LRU leaves are f32 in both
    packages, a prefill cache's conv is bf16 (the conv inputs in the
    activations' dtype) and its state f32 in both. A decode from an
    `init_cache` cache: the reference returns the conv leaf in bf16, the
    port writes the same values into the f32 leaf in place (a deliberate
    divergence, ROADMAP.md Queue 3; as the SSD's)."""
    cfg = dataclasses.replace(jreg.get_smoke_config(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype="bfloat16")
    want = _cache_leaves(_np(jlm.init_cache(cfg, B, 8)))
    got = _cache_leaves(lm.init_cache(tcfg, B, 8, device="cpu"))
    assert [(n, a.dtype, a.shape) for n, a in got] == \
        [(n, a.dtype, a.shape) for n, a in want]
    jparams = jlm.init_params(jax.random.key(0), cfg)
    params = lm_from_jax_params(_np(jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 16))
    _, wcache = jlm.prefill_step_fn(cfg, capacity=16)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    _, gcache = lm.prefill_step_fn(tcfg, capacity=16)(
        params, {"tokens": torch.from_numpy(tokens)})
    dtypes = {n: a.dtype.name for n, a in _cache_leaves(gcache)
              if n.startswith("1/")}                  # the RG-LRU stack
    assert dtypes == {"1/0/conv": "bfloat16", "1/0/state": "float32"}
    _hold_cache(gcache, _np(wcache), tol=2e-2)
    tok = tokens[:, :1]
    _, wdec = jlm.decode_step_fn(cfg)(jparams, jlm.init_cache(cfg, B, 8),
                                      jnp.asarray(tok, jnp.int32),
                                      jnp.asarray(0, jnp.int32))
    _, gdec = lm.decode_step_fn(tcfg)(params, lm.init_cache(tcfg, B, 8,
                                                            device="cpu"),
                                      torch.from_numpy(tok), 0)
    wconv = dict(_cache_leaves(_np(wdec)))["1/0/conv"]
    gconv = dict(_cache_leaves(gdec))["1/0/conv"]
    assert wconv.dtype.name == "bfloat16" and gconv.dtype == np.float32
    _close(gconv, wconv.astype(np.float32), 2e-2)    # bf16 activations


def test_init_params_builds_the_full_config_on_meta():
    params = lm.init_params(None, registry.get_config(ARCH), device="meta")
    n = lm.param_count(params)
    assert n == jlm.analytic_param_count(jreg.get_config(ARCH))
    assert 10.3e9 < n < 10.5e9


def test_mla_alone_stays_unported():
    """The full deepseek-v3-671b config (MLA) builds on the meta device,
    and its count is the reference's, 671,026,419,200."""
    params = lm.init_params(None, registry.get_config("deepseek-v3-671b"),
                            device="meta")
    n = lm.param_count(params)
    assert n == jlm.analytic_param_count(jreg.get_config("deepseek-v3-671b"))
    assert n == 671_026_419_200


# ----------------------------------------------- flash at head dim 256
# (B, Sq, Sk, H, KH, hd, causal, window, q_offset, dtype):
# recurrentgemma-9b's MQA at hd 256 with its window, a q_offset, and a
# head dim between 128 and 256
FLASH_HD256_CASES = [
    (1, 96, 96, 4, 1, 256, True, 32, 0, "float32"),
    (2, 64, 64, 2, 1, 256, True, None, 0, "float32"),
    (1, 24, 80, 4, 1, 256, True, 40, 56, "float32"),
    (1, 64, 64, 2, 1, 256, True, 16, 0, "bfloat16"),
    (1, 40, 40, 2, 2, 136, False, None, 0, "float32"),
]


@pytest.mark.parametrize("case", FLASH_HD256_CASES, ids=str)
def test_flash_attention_plain_at_hd256_matches_pallas(case):
    """The plain version (what the hd-256 kernels are held against on the
    card) against the reference's Pallas kernel in interpret mode."""
    Bq, Sq, Sk, H, KH, hd, causal, window, q_offset, dtype = case
    rng = np.random.default_rng(Sq * hd)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((Bq, Sq, H, hd), (Bq, Sk, KH, hd),
                             (Bq, Sk, KH, hd)))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want = jflash(jq, jk, jv, causal=causal, window=window,
                  q_offset=q_offset, block_q=32, block_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    before = fa.launches
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_offset=q_offset)
    assert fa.launches == before           # CPU tensors: the plain version
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_flash_attention_routes_by_head_dim():
    assert fa.route_for(torch.bfloat16, 120) == "sm90"
    assert fa.route_for(torch.float32, 128) == "tf32"
    assert fa.route_for(torch.bfloat16, 256) == "hd256"
    assert fa.route_for(torch.float32, 136) == "hd256_f32"
    q = torch.zeros((1, 4, 1, 264))
    got = fa.flash_attention(q, q, q)          # the plain version: any hd
    assert got.shape == q.shape


# ------------------------------------------------------------------- CLIs
def test_serve_cli_runs_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "20",
                     "--decode-steps", "6"])
    out = buf.getvalue()
    assert "tok/s on CPU" in out and "prefill[2x20]" in out
    assert out.count("  req") == 2
