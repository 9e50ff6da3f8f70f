"""The port's MoE ffn, SSD mixer and the two embedding front ends
(repro_torch.models) against the JAX reference (repro.models), on the
CPU at smoke size: granite-moe-3b-a800m, musicgen-large, llava-next-34b
and mamba2-2.7b.

The reference's params cross with `lm_from_jax_params`; inputs come from
numpy. With `use_pallas_attn` the reference runs its Pallas kernel in
interpret mode and the port the flash kernel's plain version. f32
tolerance: 1e-5, as tests/test_torch_lm.py.

Top-k routing picks the same experts in both packages unless a token's
k-th and (k+1)-th router scores lie within rounding of each other: such
near-ties are found from the reference's scores, counted, and left out
of the element-wise holds of `moe_apply` alone; every other token is held
at the usual tolerance, and no tolerance is widened for them.
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

from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models.config import ShapeSpec
from repro.models.inputs import make_batch as jmake_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import inputs as tinputs
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.models.params import lm_from_jax_params

ARCHS = ["granite-moe-3b-a800m", "musicgen-large", "llava-next-34b",
         "mamba2-2.7b"]
B, S = 2, 33            # mamba2's smoke chunk is 16: the forward pads 33
TOL = 1e-5
# k-th and (k+1)-th router scores closer than this (relative to the k-th)
# count as a near-tie: ~100 f32 ulps, far above the packages' rounding
# differences of the router's f32 product (~1e-7 relative)
TIE_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _inputs(cfg, seed=1):
    """(full batch, prefill batch, decode token [B,1], decode position):
    the prefill batch is the full one without its last position."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        return ({"embeddings": emb, "labels": labels},
                {"embeddings": emb[:, :S - 1]}, tok, S - 1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    full, pre = {"tokens": tokens}, {"tokens": tokens[:, :S - 1]}
    if cfg.num_patch_tokens:
        P = cfg.num_patch_tokens
        patches = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
        full["patch_embeds"] = pre["patch_embeds"] = patches
        return full, pre, tokens[:, S - 1:], P + S - 1
    return full, pre, tokens[:, S - 1:], S - 1


def _reference(cfg, params, full, pre, tok, pos):
    out = {}
    for flag in (False, True):
        c = dataclasses.replace(cfg, use_pallas_attn=flag)

        @jax.jit
        def fwd(p, batch):
            x = jlm._embed_inputs(p, c, batch)
            logits = jlm.logits_fn(p, c, jlm.forward_trunk(p, c, x))
            return logits, jlm.loss_fn(p, c, batch)
        out[flag] = _np(fwd(params, _jnp(full)))
    prefill = jax.jit(jlm.prefill_step_fn(cfg, capacity=pos + 1))
    p_logits, cache = prefill(params, _jnp(pre))
    out["prefill"] = _np((p_logits, cache))
    d_logits, cache = jax.jit(jlm.decode_step_fn(cfg))(
        params, cache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
    out["decode"] = _np((d_logits, cache))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    cfg = jreg.get_smoke_config(arch)
    jparams = jlm.init_params(jax.random.key(0), cfg)
    full, pre, tok, pos = _inputs(cfg)
    ref = _reference(cfg, jparams, full, pre, tok, pos)
    params = lm_from_jax_params(_np(jparams), registry.get_smoke_config(arch),
                                device="cpu")
    return arch, params, (full, pre, tok, pos), ref


@pytest.mark.parametrize("flag", [False, True],
                         ids=["chunked", "flash_kernel"])
def test_forward_and_loss_match_reference(case, flag):
    arch, params, (full, _, _, _), ref = case
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              use_pallas_attn=flag)
    batch = _torch(full)
    x = lm._embed_inputs(params, cfg, batch)
    logits = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
    loss = lm.loss_fn(params, cfg, batch)
    want_logits, want_loss = ref[flag]
    assert logits.shape == (B, S + cfg.num_patch_tokens, cfg.vocab_size)
    _close(logits, want_logits)
    _close(loss, want_loss)


def _numpy(v):
    """A torch or JAX leaf as numpy, bf16 as `ml_dtypes.bfloat16` (the
    JAX package's numpy dtype), bit for bit."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def _cache_leaves(cache):
    """(name, array) for every leaf of a stacked cache list."""
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


def test_prefill_and_decode_match_reference(case):
    """The logits and every cache leaf, its dtype included; granite and
    mamba2 prefill 32 tokens, llava its 16 patches and 32 tokens,
    musicgen 32 frame embeddings, and each then decodes a token."""
    arch, params, (_, pre, tok, pos), ref = case
    cfg = registry.get_smoke_config(arch)
    p_logits, cache = lm.prefill_step_fn(cfg, capacity=pos + 1)(
        params, _torch(pre))
    want_logits, want_cache = ref["prefill"]
    _close(p_logits, want_logits)
    _hold_cache(cache, want_cache)
    d_logits, cache = lm.decode_step_fn(cfg)(params, cache,
                                             torch.from_numpy(tok), pos)
    want_logits, want_cache = ref["decode"]
    _close(d_logits, want_logits)
    _hold_cache(cache, want_cache)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llava-next-34b",
                                  "mamba2-2.7b"])
def test_prefill_decode_matches_own_forward(arch):
    """Prefill without the last position + decode of its token gives the
    forward's last-position logits (musicgen's forward reads a frame
    embedding where its decode reads a token, so it has no such
    identity). granite: no token is dropped at capacity in the forward,
    the prefill or the decode, checked first (a drop makes the two
    differ)."""
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    full, pre, tok, pos = _inputs(cfg)
    full, pre = _torch(full), _torch(pre)
    if arch.startswith("granite"):
        _assert_no_drops(params, cfg, full)
        _assert_no_drops(params, cfg, pre)
    x = lm._embed_inputs(params, cfg, full)
    want = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
    _, cache = lm.prefill_step_fn(cfg, capacity=pos + 1)(params, pre)
    got, _ = lm.decode_step_fn(cfg)(params, cache, torch.from_numpy(tok),
                                    pos)
    _close(got[:, 0], want[:, -1])


def _assert_no_drops(params, cfg, batch):
    """Every MoE layer of the forward over `batch` keeps every (token,
    choice) pair."""
    seen = []
    apply = L.moe_apply

    def counting(p, c, x):
        seen.append(L.moe_dropped(p, c, x))
        return apply(p, c, x)
    L.moe_apply = counting
    try:
        lm.forward_trunk(params, cfg, lm._embed_inputs(params, cfg, batch))
    finally:
        L.moe_apply = apply
    assert len(seen) == cfg.num_layers and seen == [0] * len(seen), seen


# --------------------------------------------------------- moe_apply alone
def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _near_ties(sel: np.ndarray, k: int) -> np.ndarray:
    """Tokens whose k-th and (k+1)-th selection scores lie within
    TIE_RTOL of each other: top-k may order them either way."""
    top = -np.sort(-sel, axis=-1)
    return top[:, k - 1] - top[:, k] <= TIE_RTOL * np.abs(top[:, k - 1])


def _ref_route(jp, mc, xf):
    """The reference's (selection scores, gates, ids, dropped pairs)."""
    logits = np.asarray(jnp.asarray(xf) @ jp["router"])
    if mc.router_scale:
        sel = np.asarray(jax.nn.sigmoid(logits)) + np.asarray(jp["e_bias"])
    else:
        sel = np.asarray(jax.nn.softmax(logits, axis=-1))
    gates, ids = _np(JL._route(jp, mc, jnp.asarray(xf)))
    T = xf.shape[0]
    cap = int(np.ceil(T * mc.top_k / mc.num_experts * mc.capacity_factor))
    cap = max(8, -(-cap // 8) * 8)
    counts = np.bincount(ids.reshape(-1), minlength=mc.num_experts)
    return sel, gates, ids, int(np.maximum(counts - cap, 0).sum()), cap


MOE_CASES = {
    "smoke": {},
    "drops": {"capacity_factor": 0.25},
    "sigmoid_shared": {"router_scale": True, "num_shared_experts": 1,
                       "d_ff_shared": 24},
}


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_apply_matches_reference(name):
    base = jreg.get_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, **MOE_CASES[name]))
    jp = JL.moe_init(jax.random.key(4), cfg)
    if cfg.moe.router_scale:          # a bias that moves the selection
        jp["e_bias"] = jnp.asarray(np.random.default_rng(6).normal(
            0, 0.05, cfg.moe.num_experts), jnp.float32)
    x = np.random.default_rng(5).normal(size=(3, 40, cfg.d_model)) \
        .astype(np.float32)
    want = np.asarray(JL.moe_apply(jp, cfg, jnp.asarray(x)))
    tp = _to_torch(_np(jp))
    tcfg = dataclasses.replace(registry.get_smoke_config(
        "granite-moe-3b-a800m"), moe=cfg.moe)
    got = L.moe_apply(tp, tcfg, torch.from_numpy(x)).numpy()

    xf = x.reshape(-1, cfg.d_model)
    sel, jgates, jids, ref_drops, cap = _ref_route(jp, cfg.moe, xf)
    ties = _near_ties(sel, cfg.moe.top_k)
    gates, ids = L._route(tp, cfg.moe, torch.from_numpy(xf))
    assert L.moe_capacity(xf.shape[0], cfg.moe) == cap
    same = np.array([set(a) == set(b) for a, b in zip(ids.numpy(), jids)])
    assert np.all(same | ties), "a token without a near-tie routed apart"
    print(f"moe {name}: {int(ties.sum())} near-ties of {len(ties)} tokens, "
          f"{int((~same).sum())} routed apart; {ref_drops} pairs dropped "
          f"at capacity {cap}")
    # each token's gates by expert id, the rest at the usual tolerance
    order_g = np.argsort(ids.numpy(), axis=-1)
    order_j = np.argsort(jids, axis=-1)
    keep = ~ties
    _close(np.take_along_axis(gates.numpy(), order_g, -1)[keep],
           np.take_along_axis(jgates, order_j, -1)[keep])
    rows = keep.reshape(x.shape[:2])
    _close(got[rows], want[rows])
    assert L.moe_dropped(tp, tcfg, torch.from_numpy(x)) == ref_drops
    if name == "drops":
        assert ref_drops > 0
    elif name == "smoke":
        assert ref_drops == 0


def test_moe_capacity_is_the_reference_arithmetic():
    """`layers.py`'s `cap` expression in the reference, at the smoke and
    the chip shapes (granite at 2 x 8192 and 4 x 512 tokens)."""
    from repro_torch.models.config import MoEConfig
    for T, E, K, cf in ((66, 8, 2, 1.25), (16384, 40, 8, 1.25),
                        (2048, 40, 8, 1.25), (5, 8, 2, 0.25),
                        (100, 7, 3, 1.0)):
        cap = int(np.ceil(T * K / E * cf))
        assert L.moe_capacity(T, MoEConfig(E, K, 8, capacity_factor=cf)) \
            == max(8, -(-cap // 8) * 8)
    assert L.moe_capacity(16384, MoEConfig(40, 8, 512)) == 4096
    assert L.moe_capacity(2048, MoEConfig(40, 8, 512)) == 512


# ------------------------------------------------------------ SSD alone
def test_ssd_mix_chunked_with_initial_state_matches_reference():
    cfg = jreg.get_smoke_config("mamba2-2.7b")
    rng = np.random.default_rng(7)
    Bn, Sn, H, P, N = 2, 48, 3, 4, 16
    X = rng.normal(size=(Bn, Sn, H, P)).astype(np.float32)
    Bm = rng.normal(size=(Bn, Sn, N)).astype(np.float32)
    Cm = rng.normal(size=(Bn, Sn, N)).astype(np.float32)
    dlog = -rng.uniform(0.01, 0.5, size=(Bn, Sn, H)).astype(np.float32)
    h0 = rng.normal(size=(Bn, H, N, P)).astype(np.float32)
    wY, wh = _np(JL.ssd_mix_chunked(cfg, *map(jnp.asarray,
                                              (X, Bm, Cm, dlog, h0))))
    gY, gh = L.ssd_mix_chunked(registry.get_smoke_config("mamba2-2.7b"),
                               *map(torch.from_numpy, (X, Bm, Cm, dlog,
                                                       h0)))
    assert gY.dtype == gh.dtype == torch.float32
    _close(gY, wY)
    _close(gh, wh)


@pytest.mark.parametrize("carried", [False, True],
                         ids=["zero_state", "carried_state"])
def test_causal_conv_matches_reference(carried):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32) if carried else None
    wy, ws = JL._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    gy, gs = L._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b),
                            None if st is None else torch.from_numpy(st))
    _close(gy, np.asarray(wy))
    assert np.array_equal(gs.numpy(), np.asarray(ws))


def test_ssd_bf16_cache_dtypes_match_reference():
    """bf16 mamba2: `init_cache`'s conv is f32, a prefill cache's conv is
    bf16 (the conv inputs in the activations' dtype), state f32 in both,
    in both packages; the prefill values agree within bf16 rounding."""
    cfg = dataclasses.replace(jreg.get_smoke_config("mamba2-2.7b"),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(registry.get_smoke_config("mamba2-2.7b"),
                               dtype="bfloat16")
    want = _cache_leaves(_np(jlm.init_cache(cfg, B, 8)))
    got = _cache_leaves(lm.init_cache(tcfg, B, 8, device="cpu"))
    assert [(n, a.dtype, a.shape) for n, a in got] == \
        [(n, a.dtype, a.shape) for n, a in want]
    assert [n for n, a in got if a.dtype != np.float32] == []
    jparams = jlm.init_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 32))
    _, wcache = jlm.prefill_step_fn(cfg, capacity=32)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    params = lm_from_jax_params(_np(jparams), tcfg, device="cpu")
    _, gcache = lm.prefill_step_fn(tcfg, capacity=32)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert {n.rsplit("/", 1)[1]: a.dtype.name
            for n, a in _cache_leaves(gcache)} == {"conv": "bfloat16",
                                                   "state": "float32"}
    # bf16 activations through 2 layers: within a few bf16 ulps
    _hold_cache(gcache, _np(wcache), tol=2e-2)


# ------------------------------------------------------------ make_batch
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_draws_the_reference_arrays(arch, kind, dtype):
    shape = ShapeSpec("t", 40, 3, kind)
    cfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype=dtype)
    want = jmake_batch(cfg, shape, seed=9)
    got = tinputs.make_batch(dataclasses.replace(
        registry.get_smoke_config(arch), dtype=dtype), shape, seed=9,
        device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        if k == "pos":
            assert g == int(w)
        elif w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert g.shape == w.shape
            assert np.array_equal(g.numpy(), w), k


def test_make_batch_refuses_a_sequence_of_patches_only():
    cfg = registry.get_smoke_config("llava-next-34b")
    with pytest.raises(ValueError, match="no text"):
        tinputs.make_batch(cfg, ShapeSpec("t", 17, 1, "train"),
                           device="cpu")


# ------------------------------------------------- params cross bit for bit
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-2.7b"])
def test_lm_from_jax_params_keeps_moe_and_ssd_leaves(arch):
    """Every leaf in bf16 bit for bit; the router, the SSD's conv, decay,
    dt bias and skip, and the norms stay f32."""
    cfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype="bfloat16")
    jparams = _np(jlm.init_params(jax.random.key(3), cfg))
    tcfg = dataclasses.replace(registry.get_smoke_config(arch),
                               dtype="bfloat16")
    params = lm_from_jax_params(jparams, tcfg, device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            got[path] = t
    walk(params, ())
    assert len(got) == len(paths)
    f32 = set()
    for kp, want in paths:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp)
        g = got[key]
        if want.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, key
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  want.view(np.int16)), key
        else:
            assert g.dtype == torch.float32, key
            assert np.array_equal(g.numpy(), want), key
            f32.add(key[-1] if key[-1] != "scale" else key[-2])
    if arch.startswith("granite"):
        assert "router" in f32
        assert params["stacks"][0][0]["ffn"]["w_gate"].dtype == \
            torch.bfloat16
    else:
        assert {"conv_w", "conv_b", "A_log", "dt_bias", "D_skip"} <= f32
    assert lm.param_count(params) == sum(a.size for _, a in paths)


def test_init_params_builds_the_full_configs_on_meta():
    """The four archs' full configs build (shapes alone), with the
    reference's parameter counts."""
    counts = {}
    for arch in ARCHS:
        params = lm.init_params(None, registry.get_config(arch),
                                device="meta")
        counts[arch] = lm.param_count(params)
        assert counts[arch] == jlm.analytic_param_count(
            jreg.get_config(arch)), arch
    assert 3.2e9 < counts["granite-moe-3b-a800m"] < 3.4e9
    assert 2.6e9 < counts["mamba2-2.7b"] < 2.8e9


# ------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-2.7b"])
def test_serve_cli_runs_on_cpu(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "20",
                     "--decode-steps", "6"])
    out = buf.getvalue()
    assert "tok/s on CPU" in out and "prefill[2x20]" in out
    assert out.count("  req") == 2


@pytest.mark.parametrize("arch,need", [("musicgen-large", "embeddings"),
                                       ("llava-next-34b", "patch_embeds")])
def test_serve_refuses_front_end_archs(arch, need):
    """The serve loop feeds token prompts only, as the reference's does
    (which fails with a KeyError there): the port refuses, naming the
    missing input, before it builds a model."""
    with pytest.raises(ValueError, match=need):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    cfg = registry.get_smoke_config(arch)
    with pytest.raises(ValueError, match=need):
        tserve.serve_loop(None, cfg, torch.zeros((1, 4), dtype=torch.long),
                          decode_steps=1)
