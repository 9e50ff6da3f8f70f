"""The port's dense-attention LM (repro_torch.models) against the JAX
reference (repro.models), on the CPU at smoke size.

The reference's params cross with `lm_from_jax_params`; tokens come from
numpy. The JAX side is traced once per arch (module-scoped fixtures).
With `use_pallas_attn` the reference runs its Pallas kernel in interpret
mode (as it does by itself on the CPU) and the port the flash kernel's
plain version. f32 tolerance: 1e-5 (the two frameworks sum matmuls in
other orders; the logits are O(1)).
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

from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models.config import SMOKE_SHAPE
from repro.models.inputs import make_batch as jmake_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import inputs as tinputs
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.models.params import lm_from_jax_params

ARCHS = ["h2o-danube-3-4b", "yi-9b", "qwen3-14b"]
B, S = 2, 33            # S - 1 = 32 > the danube smoke window of 16: the
#                         prefill ring buffer wraps
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _reference(cfg, params, tokens):
    """Everything the tests compare, computed by the JAX package."""
    out = {}
    for flag in (False, True):
        c = dataclasses.replace(cfg, use_pallas_attn=flag)

        @jax.jit
        def fwd(p, tok):
            x = jlm._embed_inputs(p, c, {"tokens": tok})
            logits = jlm.logits_fn(p, c, jlm.forward_trunk(p, c, x))
            return logits, jlm.loss_fn(p, c, {"tokens": tok})
        out[flag] = _np(fwd(params, tokens))
    prefill = jax.jit(jlm.prefill_step_fn(cfg, capacity=S))
    decode = jax.jit(jlm.decode_step_fn(cfg))
    p_logits, cache = prefill(params, {"tokens": tokens[:, :S - 1]})
    out["prefill"] = _np((p_logits, cache))
    d_logits, cache = decode(params, cache, tokens[:, S - 1:S],
                             jnp.asarray(S - 1, jnp.int32))
    out["decode"] = _np((d_logits, cache))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    cfg = jreg.get_smoke_config(arch)
    jparams = jlm.init_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    ref = _reference(cfg, jparams, jnp.asarray(tokens, jnp.int32))
    params = lm_from_jax_params(_np(jparams), registry.get_smoke_config(arch),
                                device="cpu")
    return arch, params, torch.from_numpy(tokens), ref


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("flag", [False, True],
                         ids=["chunked", "flash_kernel"])
def test_forward_and_loss_match_reference(case, flag):
    arch, params, tokens, ref = case
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              use_pallas_attn=flag)
    x = lm._embed_inputs(params, cfg, {"tokens": tokens})
    logits = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
    loss = lm.loss_fn(params, cfg, {"tokens": tokens})
    want_logits, want_loss = ref[flag]
    assert logits.shape == (B, S, cfg.vocab_size)
    _close(logits, want_logits)
    _close(loss, want_loss)


def _cache_leaves(cache):
    """(name, array) for every leaf of a stacked cache list."""
    out = []
    for si, stack in enumerate(cache):
        for ei, elem in enumerate(stack):
            for k in sorted(elem):
                out.append((f"{si}/{ei}/{k}", np.asarray(elem[k])))
    return out


def test_prefill_and_decode_match_reference(case):
    arch, params, tokens, ref = case
    cfg = registry.get_smoke_config(arch)
    p_logits, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :S - 1]})
    want_logits, want_cache = ref["prefill"]
    _close(p_logits, want_logits)
    got = _cache_leaves(cache)
    assert [n for n, _ in got] == [n for n, _ in _cache_leaves(want_cache)]
    for (name, a), (_, b) in zip(got, _cache_leaves(want_cache)):
        if name.endswith("k_pos"):
            assert a.dtype == np.int32 and np.array_equal(a, b), name
        else:
            _close(a, b)
    d_logits, cache = lm.decode_step_fn(cfg)(params, cache,
                                             tokens[:, S - 1:S], S - 1)
    want_logits, want_cache = ref["decode"]
    _close(d_logits, want_logits)
    for (name, a), (_, b) in zip(_cache_leaves(cache),
                                 _cache_leaves(want_cache)):
        if name.endswith("k_pos"):
            assert np.array_equal(a, b), name
        else:
            _close(a, b)


def test_prefill_with_the_flag_matches_reference(case):
    """With `use_pallas_attn` the port prefills through the flash kernel
    (its plain version here), where the reference keeps
    `chunked_attention`: the last prompt position's logits against the
    reference's flag-on forward over the same prefix (the Pallas kernel),
    the caches against the reference's prefill at TOL (the two
    frameworks' projections sum in other orders, so no layer is equal bit
    for bit), the first layer's against the port's flag-off prefill bit
    for bit (its keys and values come before any attention)."""
    arch, params, tokens, ref = case
    cfg = registry.get_smoke_config(arch)
    prompt = {"tokens": tokens[:, :S - 1]}
    p_logits, cache = lm.prefill_step_fn(
        dataclasses.replace(cfg, use_pallas_attn=True), capacity=S)(
            params, prompt)
    _, own_cache = lm.prefill_step_fn(cfg, capacity=S)(params, prompt)
    want_logits, _ = ref[True]
    _close(p_logits, want_logits[:, S - 2:S - 1])
    _, want_cache = ref["prefill"]
    got, want = _cache_leaves(cache), _cache_leaves(want_cache)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b), (_, c) in zip(got, want, _cache_leaves(own_cache)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a[0], c[0]), name
        if name.endswith("k_pos"):
            assert np.array_equal(a, b), name
        else:
            _close(a, b)


def test_prefill_decode_matches_own_forward(case):
    """Prefill on S-1 tokens + decode of token S-1 gives the forward's
    last-position logits (the reference's own check,
    tests/test_models.py::test_prefill_decode_matches_forward)."""
    arch, params, tokens, _ = case
    cfg = registry.get_smoke_config(arch)
    x = lm._embed_inputs(params, cfg, {"tokens": tokens})
    full = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x))
    _, cache = lm.prefill_step_fn(cfg, capacity=S)(
        params, {"tokens": tokens[:, :S - 1]})
    logits, _ = lm.decode_step_fn(cfg)(params, cache, tokens[:, S - 1:S],
                                       S - 1)
    _close(logits[:, 0], full[:, -1])


def test_bf16_danube_matches_reference():
    """bf16 weights and activations. Both sides round to bf16 at the same
    points (the projections, norms, rope, q·scale, the attention output,
    the residual adds), but a product or an elementwise chain that one
    framework keeps in f32 longer than the other moves a value by a bf16
    ulp (2^-8 relative) now and then; through 2 layers that stays under
    3 ulps of the O(1) logits: tolerance 2e-2 relative and absolute."""
    cfg = dataclasses.replace(jreg.get_smoke_config("h2o-danube-3-4b"),
                              dtype="bfloat16")
    jparams = jlm.init_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    x = jlm._embed_inputs(jparams, cfg, {"tokens": jnp.asarray(tokens)})
    want = jlm.logits_fn(jparams, cfg, jlm.forward_trunk(jparams, cfg, x))
    tcfg = dataclasses.replace(
        registry.get_smoke_config("h2o-danube-3-4b"), dtype="bfloat16")
    params = lm_from_jax_params(_np(jparams), tcfg, device="cpu")
    got = lm.logits_fn(params, tcfg, lm.forward_trunk(
        params, tcfg, lm._embed_inputs(params, tcfg,
                                       {"tokens": _t(tokens)})))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), tol=2e-2)


def test_lm_from_jax_params_keeps_bf16_bits():
    cfg = dataclasses.replace(jreg.get_smoke_config("yi-9b"),
                              dtype="bfloat16")
    jparams = _np(jlm.init_params(jax.random.key(3), cfg))
    tcfg = dataclasses.replace(registry.get_smoke_config("yi-9b"),
                               dtype="bfloat16")
    params = lm_from_jax_params(jparams, tcfg, device="cpu")
    pairs = [(params["embed"], jparams["embed"]),
             (params["lm_head"], jparams["lm_head"]),
             (params["final_norm"]["scale"], jparams["final_norm"]["scale"])]
    for k in ("wq", "wk", "wv", "wo"):
        pairs.append((params["stacks"][0][0]["mixer"][k],
                      jparams["stacks"][0][0]["mixer"][k]))
    for got, want in pairs:
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
        else:
            assert np.array_equal(got.numpy(), want)
    assert lm.param_count(params) == sum(
        a.size for a in jax.tree_util.tree_leaves(jparams))


def test_lm_from_jax_params_checks_shapes():
    cfg = jreg.get_smoke_config("yi-9b")
    jparams = _np(jlm.init_params(jax.random.key(0), cfg))
    jparams["embed"] = jparams["embed"][:-1]
    with pytest.raises(ValueError, match="embed: shape"):
        lm_from_jax_params(jparams, registry.get_smoke_config("yi-9b"),
                           device="cpu")


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_configs_match_reference(arch, size):
    """Every key of the reference's config with its value, and each of
    the port's own fields (MusicGen's decoder as published) at the
    default that runs what the reference runs."""
    get = {"full": (jreg.get_config, registry.get_config),
           "smoke": (jreg.get_smoke_config, registry.get_smoke_config)}[size]
    got, want = get[1](arch).to_dict(), get[0](arch).to_dict()
    assert {k: got[k] for k in want if k in got} == want
    assert {k: v for k, v in got.items() if k not in want} == PORT_ONLY


# the port's own config fields and their defaults
PORT_ONLY = {"norm": "rms", "mlp": "swiglu", "positions": "rope",
             "num_codebooks": 0, "cross_attn_dim": 0}


def test_registry_lists_the_same_archs():
    assert registry.list_archs() == jreg.list_archs()
    assert all(m.startswith("repro_torch.configs.")
               for m in registry.ARCHS.values())


def test_make_batch_draws_the_reference_tokens():
    for arch in ("h2o-danube-3-4b", "qwen3-14b"):
        want = jmake_batch(jreg.get_smoke_config(arch), SMOKE_SHAPE, seed=5)
        got = tinputs.make_batch(registry.get_smoke_config(arch),
                                 SMOKE_SHAPE, seed=5, device="cpu")
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))


def test_serve_cli_runs_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--arch", "h2o-danube-3-4b", "--smoke", "--device",
                     "cpu", "--batch", "2", "--prompt-len", "20",
                     "--decode-steps", "6"])
    out = buf.getvalue()
    assert "tok/s on CPU" in out and "prefill[2x20]" in out
    assert out.count("  req") == 2


def test_serve_loop_greedy_follows_the_logits():
    """Greedy decoding picks the argmax of the logits it was given:
    replaying prompt + generated tokens through the forward reproduces
    every generated token."""
    cfg = registry.get_smoke_config("yi-9b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = tserve.prompts(cfg, 2, 12, seed=0, device="cpu")
    res = tserve.serve_loop(params, cfg, tokens, decode_steps=5)
    gen = res["tokens"]
    assert gen.shape == (2, 5)
    seq = torch.cat([tokens, gen], dim=1)
    logits = lm.logits_fn(params, cfg, lm.forward_trunk(
        params, cfg, lm._embed_inputs(params, cfg, {"tokens": seq})))
    assert torch.equal(logits[:, 11:-1].argmax(-1), gen)


def _tree(tree, path=""):
    """(path, shape, dtype) of every leaf, dict keys sorted as JAX
    flattens them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _tree(t, f"{path}/{i}")]
    return [(path, tuple(tree.shape),
             str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("entry", ["init_params", "init_cache"])
def test_unported_archs_raise(entry):
    """deepseek-v3-671b (MLA), the last arch to be ported, builds: its
    params' and its decode cache's trees are the reference's (paths,
    shapes, dtypes), and the empty cache's values too."""
    cfg = registry.get_smoke_config("deepseek-v3-671b")
    jcfg = jreg.get_smoke_config("deepseek-v3-671b")
    if entry == "init_params":
        got = lm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
        want = _np(jlm.init_params(jax.random.key(0), jcfg))
    else:
        got = lm.init_cache(cfg, 2, 16, device="cpu")
        want = _np(jlm.init_cache(jcfg, 2, 16))
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert np.array_equal(g.numpy(), w)
    assert _tree(got) == _tree(want)
    assert {p.rsplit("/", 1)[1] for p, _, _ in _tree(got)} >= (
        {"wdq", "wuq", "wdkv", "wuk", "wuv", "wo"} if entry == "init_params"
        else {"ckv", "krope", "k_pos"})
