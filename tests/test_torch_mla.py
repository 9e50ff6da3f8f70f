"""The port's MLA mixer (DeepSeek-V3's multi-head latent attention,
repro_torch.models.layers.mla_*) and deepseek-v3-671b end to end against
the JAX reference (repro.models), on the CPU at the smoke config
(`deepseek-v3-671b-smoke`: f32, d_model 64, 4 heads, one dense and one
MoE layer, block_kv 16); then the abstract trio (`init_abstract`,
`cache_abstract`, `analytic_param_count`) and `input_specs` for all ten
archs, smoke and full, against the reference's `jax.eval_shape` trees
and ShapeDtypeStructs.

The reference's params cross with `lm_from_jax_params`; inputs come from
numpy. f32 tolerance: 1e-5 (as tests/test_torch_lm.py); bf16: 2e-2
relative and absolute (as its bf16 test: a bf16 ulp is 2^-8). MoE
near-ties (the k-th and (k+1)-th router selection scores within 1e-5
relative, as tests/test_torch_lm_zoo.py) are counted and printed, never
tolerated: every value is held at the tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.models import inputs as jinputs
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models.config import SHAPES, SMOKE_SHAPE, ShapeSpec
from repro_torch.models import inputs as tinputs
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.models.params import lm_from_jax_params
from repro_torch.training.optim import tree_leaves

ARCH = "deepseek-v3-671b"
B, S = 2, 33            # S > 2 blocks of the smoke block_kv (16), ragged
DECODE_STEPS = 8
TOL = 1e-5
BF16_TOL = 2e-2
TIE_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy(v):
    """A torch or JAX leaf as numpy, bf16 as `ml_dtypes.bfloat16`."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def _torch(a):
    """A numpy or JAX leaf as a torch tensor, bf16 kept bf16."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(_numpy(got), np.float64),
                               np.asarray(_numpy(want), np.float64),
                               rtol=tol, atol=tol)


def _cache_leaves(cache):
    return [(f"{si}/{ei}/{k}", _numpy(elem[k]))
            for si, stack in enumerate(cache)
            for ei, elem in enumerate(stack) for k in sorted(elem)]


def _hold_cache(got, want, tol=TOL):
    """Every leaf: its name, dtype and values; `k_pos` bit for bit."""
    got, want = _cache_leaves(got), _cache_leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [n.rsplit("/", 1)[1] for n, _ in got] == \
        ["ckv", "k_pos", "krope"] * 2
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.endswith("k_pos"):
            assert np.array_equal(a, b), name
        else:
            _close(a, b, tol)


def _near_ties(params, cfg, batch) -> list:
    """Per MoE call of the port's forward over `batch`: the tokens whose
    k-th and (k+1)-th router selection scores lie within TIE_RTOL."""
    seen = []
    apply = L.moe_apply

    def counting(p, c, x):
        xf = x.reshape(-1, x.shape[-1]).float()
        sel = torch.sigmoid(xf @ p["router"]) + p["e_bias"][None, :]
        top = sel.topk(c.moe.top_k + 1, dim=-1).values
        seen.append(int(((top[:, -2] - top[:, -1])
                         <= TIE_RTOL * top[:, -2].abs()).sum()))
        return apply(p, c, x)
    L.moe_apply = counting
    try:
        with torch.no_grad():
            lm.forward_trunk(params, cfg, lm._embed_inputs(params, cfg,
                                                           batch))
    finally:
        L.moe_apply = apply
    return seen


# ------------------------------------------------------ the whole model
def _reference(cfg, params, tokens, steps):
    """By the JAX package: the forward's logits and loss over `tokens`;
    the prefill of its first S - `steps` positions; then `steps`
    teacher-forced decode steps of the rest (logits and cache each)."""
    out = {}

    @jax.jit
    def fwd(p, tok):
        x = jlm._embed_inputs(p, cfg, {"tokens": tok})
        logits = jlm.logits_fn(p, cfg, jlm.forward_trunk(p, cfg, x))
        return logits, jlm.loss_fn(p, cfg, {"tokens": tok})
    out["forward"] = _np(fwd(params, tokens))
    P = S - steps
    prefill = jax.jit(jlm.prefill_step_fn(cfg, capacity=S))
    p_logits, cache = prefill(params, {"tokens": tokens[:, :P]})
    out["prefill"] = _np((p_logits, cache))
    decode = jax.jit(jlm.decode_step_fn(cfg))
    out["decode"] = []
    for t in range(P, S):
        logits, cache = decode(params, cache, tokens[:, t:t + 1],
                               jnp.asarray(t, jnp.int32))
        out["decode"].append(_np((logits, cache)))
    return out


def _case(dtype):
    cfg = dataclasses.replace(jreg.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH), dtype=dtype)
    jparams = jlm.init_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    ref = _reference(cfg, jparams, jnp.asarray(tokens, jnp.int32),
                     DECODE_STEPS)
    params = lm_from_jax_params(_np(jparams), tcfg, device="cpu")
    return tcfg, params, torch.from_numpy(tokens), ref


@pytest.fixture(scope="module")
def f32_case():
    return _case("float32")


@pytest.fixture(scope="module")
def bf16_case():
    return _case("bfloat16")


def _port_forward(cfg, params, tokens):
    with torch.no_grad():
        x = lm._embed_inputs(params, cfg, {"tokens": tokens})
        logits = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
        return logits, lm.loss_fn(params, cfg, {"tokens": tokens})


@pytest.mark.parametrize("flag", [False, True],
                         ids=["chunked", "use_pallas_attn"])
def test_forward_and_loss_match_reference(f32_case, flag):
    """forward_trunk / logits_fn / loss_fn. MLA attends with
    chunked_attention whatever `use_pallas_attn` says, in both packages:
    the flag changes no number."""
    cfg, params, tokens, ref = f32_case
    cfg = dataclasses.replace(cfg, use_pallas_attn=flag)
    ties = _near_ties(params, cfg, {"tokens": tokens})
    print(f"MoE near-ties per MoE layer: {ties}")
    logits, loss = _port_forward(cfg, params, tokens)
    want_logits, want_loss = ref["forward"]
    assert logits.shape == (B, S, cfg.vocab_size)
    _close(logits, want_logits)
    _close(loss, want_loss)


def test_prefill_matches_reference(f32_case):
    cfg, params, tokens, ref = f32_case
    P = S - DECODE_STEPS
    logits, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :P]})
    want_logits, want_cache = ref["prefill"]
    _close(logits, want_logits)
    _hold_cache(cache, want_cache)
    kp = cache[0][0]["k_pos"]
    assert kp.shape == (1, B, S) and int(kp[0, 0, P - 1]) == P - 1 \
        and int(kp[0, 0, P]) == -1


def test_decode_steps_match_reference(f32_case):
    """Eight absorbed-form decode steps after the prefill, each step's
    logits and the whole cache after it."""
    cfg, params, tokens, ref = f32_case
    P = S - DECODE_STEPS
    _, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :P]})
    decode = lm.decode_step_fn(cfg)
    for i, t in enumerate(range(P, S)):
        logits, cache = decode(params, cache, tokens[:, t:t + 1], t)
        want_logits, want_cache = ref["decode"][i]
        _close(logits, want_logits)
        _hold_cache(cache, want_cache)


def test_decode_matches_own_forward(f32_case):
    """The absorbed decode against the port's own (unabsorbed) forward at
    the last position, with no pair dropped at capacity."""
    cfg, params, tokens, _ = f32_case
    drops = []
    apply = L.moe_apply

    def counting(p, c, x):
        drops.append(L.moe_dropped(p, c, x))
        return apply(p, c, x)
    L.moe_apply = counting
    try:
        want, _ = _port_forward(cfg, params, tokens)
    finally:
        L.moe_apply = apply
    assert drops == [0, 0]              # logits_fn's pass and loss_fn's
    _, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :S - 1]})
    got, _ = lm.decode_step_fn(cfg)(params, cache, tokens[:, S - 1:], S - 1)
    _close(got[:, 0], want[:, -1])


def test_bf16_forward_and_decode_match_reference(bf16_case):
    """bf16: forward, prefill, decode and the cache within a few bf16
    ulps. Too coarse to see the absorbed decode's rounding points (see
    the next test)."""
    cfg, params, tokens, ref = bf16_case
    logits, loss = _port_forward(cfg, params, tokens)
    assert logits.dtype == torch.bfloat16
    _close(logits.float(), ref["forward"][0].astype(np.float32), BF16_TOL)
    _close(loss, ref["forward"][1], BF16_TOL)
    P = S - DECODE_STEPS
    logits, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :P]})
    _close(logits.float(), ref["prefill"][0].astype(np.float32), BF16_TOL)
    decode = lm.decode_step_fn(cfg)
    for i, t in enumerate(range(P, S)):
        logits, cache = decode(params, cache, tokens[:, t:t + 1], t)
        want_logits, want_cache = ref["decode"][i]
        _close(logits.float(), want_logits.astype(np.float32), BF16_TOL)
    got, want = _cache_leaves(cache), _cache_leaves(want_cache)
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, name
        if name.endswith("k_pos"):
            assert np.array_equal(a, b), name
        else:
            _close(a.astype(np.float32), b.astype(np.float32), BF16_TOL)


# bf16 decode alone: the cache's latents drawn at 8 x N(0, 1) sharpen the
# scores, so that one rounding of q_lat more or less moves the output
BF16_CKV_SCALE = 8.0
# mean|Δ| <= 2^-14·mean|ref|: one output element in 64 a bf16 ulp off
BF16_DECODE_TOL = 2.0 ** -14


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_decode_keeps_the_reference_rounding_points(seed):
    """`mla_apply_decode` in bf16 against the reference's, one step into
    a cache of 40 positions: q_lat rounded to bf16 before its f32 cast,
    ctx_lat cast back before wuv. The port matched it bit for bit at
    these seeds; keeping q_lat in f32, or ctx_lat in f32 through wuv,
    moved the mean error to 15-57 times the limit."""
    cfg = dataclasses.replace(jreg.get_smoke_config(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype="bfloat16")
    m = cfg.mla
    Bd, cap, T = 4, 48, 40
    jp = JL.mla_init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(10 + seed)
    x = rng.normal(size=(Bd, 1, cfg.d_model)).astype(np.float32)
    ckv = BF16_CKV_SCALE * rng.normal(size=(Bd, cap, m.kv_lora_rank))
    krope = rng.normal(size=(Bd, cap, m.qk_rope_head_dim))
    k_pos = np.where(np.arange(cap) < T, np.arange(cap), -1)[None] \
        .repeat(Bd, 0).astype(np.int32)
    cache = {"ckv": jnp.asarray(ckv, jnp.bfloat16),
             "krope": jnp.asarray(krope, jnp.bfloat16),
             "k_pos": jnp.asarray(k_pos)}
    want, _ = JL.mla_apply_decode(jp, cfg, jnp.asarray(x, jnp.bfloat16),
                                  cache, jnp.asarray(T, jnp.int32))
    tp = jax.tree_util.tree_map(_torch, _np(jp))
    tcache = {k: _torch(v) for k, v in cache.items()}
    got, _ = L.mla_apply_decode(tp, tcfg, torch.from_numpy(x).to(
        torch.bfloat16), tcache, T)
    assert got.dtype == torch.bfloat16 and got.shape == (Bd, 1, cfg.d_model)
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).mean() / np.abs(want).mean()
    print(f"mean|Δ|/mean|ref| {err:.3e}, "
          f"{int((got != want).sum())} of {got.size} elements differ")
    assert err <= BF16_DECODE_TOL


# ------------------------------------------------------ the mixer alone
@pytest.mark.parametrize("q_offset", [0, 5])
def test_mla_apply_train_matches_reference(q_offset):
    cfg = jreg.get_smoke_config(ARCH)
    jp = JL.mla_init(jax.random.key(3), cfg)
    x = np.random.default_rng(4).normal(size=(B, 40, cfg.d_model)) \
        .astype(np.float32)
    want = JL.mla_apply_train(jp, cfg, jnp.asarray(x), q_offset=q_offset)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                _np(jp))
    got = L.mla_apply_train(tp, registry.get_smoke_config(ARCH),
                            torch.from_numpy(x), q_offset=q_offset)
    assert got.shape == (B, 40, cfg.d_model)
    _close(got, want)


def test_mla_latent_ropes_the_shared_key_over_its_last_axis():
    """The rope key is roped as a [B,S,1,rope] view: at position p its
    pair (i, i + rope/2) turns by p·theta^(-i/(rope/2)), the same for
    every position's batch rows, and the latent is the normed first
    kv_lora columns."""
    cfg = registry.get_smoke_config(ARCH)
    m = cfg.mla
    p = L.mla_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 6, cfg.d_model)).astype(np.float32))
    positions = torch.arange(6)
    ckv, k_rope = L._mla_kv_latent(p, cfg, x, positions)
    dkv = x @ p["wdkv"]
    assert ckv.shape == (1, 6, m.kv_lora_rank)
    torch.testing.assert_close(ckv, L.rmsnorm(p["kv_norm"],
                                              dkv[..., :m.kv_lora_rank],
                                              cfg.norm_eps))
    half = m.qk_rope_head_dim // 2
    raw = dkv[0, :, m.kv_lora_rank:].double()
    ang = positions.double()[:, None] * cfg.rope_theta ** (
        -torch.arange(half).double() / half)
    want = torch.cat([raw[:, :half] * ang.cos() - raw[:, half:] * ang.sin(),
                      raw[:, :half] * ang.sin() + raw[:, half:] * ang.cos()],
                     dim=-1)
    torch.testing.assert_close(k_rope[0].double(), want, rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- the train step
@pytest.mark.timeout(300)
def test_train_step_matches_reference():
    """One Adafactor step (the config's optimizer) on 4 x 32 tokens in
    microbatches of 2, at tests/test_torch_lm_train.py's tolerance and
    gradient mask: the loss within 1e-5 relative; the params within f32
    rounding where the reference's gradient is above 1e-3 of its largest,
    and within the step's bound 2·lr elsewhere."""
    from repro.models.inputs import make_batch as jmake_batch
    cfg = jreg.get_smoke_config(ARCH)
    tcfg = registry.get_smoke_config(ARCH)
    assert cfg.optimizer == "adafactor" and tcfg.microbatch < 4
    jparams = jlm.init_params(jax.random.key(0), cfg)
    batch = {k: np.array(v) for k, v in jmake_batch(
        cfg, ShapeSpec("train", 32, 4, "train"), seed=1).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt_init, _ = jlm.make_optimizer(cfg)
    jnew, _, stats = jax.jit(jlm.train_step_fn(cfg))(
        jparams, opt_init(jparams), jb)
    grads = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, cfg, jb)))(jparams)
    lr = float(stats["lr"])
    params = lm_from_jax_params(_np(jparams), tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    print(f"MoE near-ties per MoE layer: {_near_ties(params, tcfg, tb)}")
    t_init, _ = lm.make_optimizer(tcfg)
    new, _, tstats = lm.train_step_fn(tcfg)(params, t_init(params), tb)
    assert float(tstats["loss"]) == pytest.approx(float(stats["loss"]),
                                                  rel=1e-5)
    port = [x.detach().numpy() for x in tree_leaves(new)]
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jnew)]
    gs = [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]
    assert len(port) == len(ref)
    gmax = max(float(np.abs(g).max()) for g in gs)
    for p, j, g in zip(port, ref, gs):
        big = np.abs(g) > 1e-3 * gmax
        np.testing.assert_allclose(p[big], j[big], rtol=1e-6, atol=1e-7)
        assert np.all(np.abs(p - j) <= 2 * lr * (1 + 1e-6))


# ------------------------------------- abstract trio and input specs
ALL_ARCHS = sorted(registry.ARCHS)
SIZES = ["smoke", "full"]


def _configs(arch, size):
    if size == "smoke":
        return jreg.get_smoke_config(arch), registry.get_smoke_config(arch)
    return jreg.get_config(arch), registry.get_config(arch)


def _flat(tree, path=""):
    """(path, shape, dtype name) of every leaf, dict keys sorted (JAX's
    flatten order); list entries as [i], tuple entries as (i)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        br = "[]" if isinstance(tree, list) else "()"
        return [x for i, t in enumerate(tree)
                for x in _flat(t, f"{path}{br[0]}{i}{br[1]}")]
    dtype = str(tree.dtype).replace("torch.", "")
    return [(path, tuple(int(d) for d in tree.shape), dtype)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_param_count_matches_reference(arch, size):
    jcfg, tcfg = _configs(arch, size)
    n = lm.analytic_param_count(tcfg)
    assert n == jlm.analytic_param_count(jcfg)
    if arch == ARCH and size == "full":
        assert n == 671_026_419_200


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_abstract_matches_reference(arch, size):
    jcfg, tcfg = _configs(arch, size)
    got = lm.init_abstract(tcfg)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _flat(got) == _flat(jlm.init_abstract(jcfg))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_abstract_matches_reference(arch, size):
    """At the smoke shape (2 x 64) or decode_32k's (128 x 32768, past
    every window)."""
    jcfg, tcfg = _configs(arch, size)
    batch, cap = (2, 64) if size == "smoke" else (
        SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len)
    got = lm.cache_abstract(tcfg, batch, cap)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _flat(got) == _flat(jlm.cache_abstract(jcfg, batch, cap))


INT64_FOR_INT32 = ("tokens", "labels", "pos")


@pytest.mark.parametrize("shape", ["train", "prefill", "decode"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_reference(arch, size, shape):
    """The reference's keys in its order, its shapes, its dtypes but for
    the token ids and decode's pos: int32 there, int64 in the port (as
    make_batch gives them)."""
    jcfg, tcfg = _configs(arch, size)
    if size == "smoke":
        spec = dataclasses.replace(SMOKE_SHAPE, kind=shape)
    else:
        spec = SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                       "decode": "decode_32k"}[shape]]
    want = jinputs.input_specs(jcfg, spec)
    got = tinputs.input_specs(tcfg, spec)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), k
        wd = np.dtype(w.dtype).name
        if k in INT64_FOR_INT32:
            assert wd == "int32" and g.dtype == torch.int64, k
        else:
            assert str(g.dtype).replace("torch.", "") == wd, k


def test_make_batch_follows_the_specs():
    """make_batch's arrays have the specs' shapes and dtypes, and its
    numbers are the reference's."""
    cfg = registry.get_smoke_config("llava-next-34b")
    for kind in ("train", "decode"):
        shape = ShapeSpec("t", 40, 3, kind)
        specs = tinputs.input_specs(cfg, shape)
        got = tinputs.make_batch(cfg, shape, seed=2, device="cpu")
        want = jinputs.make_batch(jreg.get_smoke_config("llava-next-34b"),
                                  shape, seed=2)
        assert list(got) == list(specs) == list(want)
        for k, s in specs.items():
            if k == "pos":
                assert got[k] == int(want[k]) == 39
                continue
            assert got[k].shape == s.shape and got[k].dtype == s.dtype
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
