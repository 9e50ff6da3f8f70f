"""MusicGen's decoder as a config of the port (`norm="layer"`,
`mlp="gelu"`, `positions="sinusoidal"`, `num_codebooks`,
`cross_attn_dim`), against the plain float32 reference
(`tests/musicgen_reference.py`), on the CPU at a small size: d 64, 2
layers, 4 heads, 4 codebooks of 32 codes, text states of width 24 and
length 8. One `cuda` test holds 2 layers at the published widths on the
card. This file imports nothing of JAX.

Tolerances: the port and the reference compute in float32 here and
differ only in the order of their sums (the flash kernel's plain version
or `chunked_attention`, einsum layouts, one f32 rounding of the summed
embeddings), about 1e-6 of a norm over 2 layers; `REL` = 1e-5 leaves
that ten times of room, and each planted fault reads 1e-3 or more.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, Stack
from tests import musicgen_reference as ref

K, V, T, DX = 4, 32, 8, 24
REL = 1e-5


def _cfg(**kw) -> ModelConfig:
    base = dict(name="musicgen-tiny", family="audio", d_model=64,
                vocab_size=V, num_heads=4, num_kv_heads=4, d_ff=128,
                stacks=(Stack(("attn+mlp",), 2),), norm="layer",
                mlp="gelu", positions="sinusoidal", num_codebooks=K,
                cross_attn_dim=DX, norm_eps=1e-5, dtype="float32",
                block_kv=4, use_pallas_attn=True)
    return ModelConfig(**{**base, **kw})


@pytest.fixture(autouse=True)
def _closed():
    """No test leaves a recording open for the next."""
    yield
    if tracing._rec is not None:
        tracing.stop()


def _draw(tree, gen, path=()):
    """Every leaf drawn anew: norm scales 1 + N(0, 0.1), biases N(0, 0.1),
    the rest N(0, 0.05), so that every part moves the output."""
    if isinstance(tree, dict):
        return {k: _draw(v, gen, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_draw(v, gen, path) for v in tree)
    x = torch.randn(tree.shape, generator=gen, dtype=torch.float32)
    if path[-1] == "scale":
        return 1 + 0.1 * x
    return x * (0.1 if path[-1] in ("bias", "b") else 0.05)


def _params(cfg, seed=0):
    return _draw(lm.init_abstract(cfg), torch.Generator().manual_seed(seed))


def _prompt(B, P, seed=1):
    """A delayed prompt of P positions: position 0 the start, codebook k
    pad up to position k, random codes after."""
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, V, (B, K, P), generator=g)
    for k in range(K):
        codes[:, k, :k + 1] = V
    return codes, torch.randn(B, T, DX, generator=g)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _cache_rel(caches, want) -> float:
    """Largest rel error over layers and the reference's cached tensors,
    the program's read as far as the reference's positions go (inf for
    a tensor the program does not cache)."""
    stack = caches[0][0]
    worst = 0.0
    for i, w in enumerate(want):
        for name, t in w.items():
            if name not in stack:
                return float("inf")
            got = stack[name][i]
            worst = max(worst, _rel(got[:, :t.shape[1]], t))
    return worst


def _prefill_errs(cfg, params, codes, text):
    S = codes.shape[-1]
    with torch.inference_mode():
        logits, caches = lm.prefill_step_fn(cfg, capacity=S + 4)(
            params, {"codes": codes, "text": text})
    want, want_caches = ref.forward(params, codes, text)
    return _rel(logits[:, -1], want[:, -1]), _cache_rel(caches, want_caches)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
def test_prefill_matches_reference(flash):
    cfg = _cfg(use_pallas_attn=flash)
    params = _params(cfg)
    codes, text = _prompt(3, 12)
    logits_err, cache_err = _prefill_errs(cfg, params, codes, text)
    assert logits_err < REL and cache_err < REL


def test_prefill_then_decode_matches_reference_every_codebook():
    """Prefill 6 positions, then 9 decode steps through the caches with
    the delay pattern fed back: every step's logits of every codebook and
    the final caches against the reference's one forward over the whole
    delayed sequence."""
    cfg = _cfg()
    params = _params(cfg, seed=3)
    B, P, n = 2, 6, 9
    frames = P + n - K
    seq, text = _prompt(B, P, seed=4)
    got = []
    with torch.inference_mode():
        logits, caches = lm.prefill_step_fn(cfg, capacity=P + n)(
            params, {"codes": seq, "text": text})
        for t in range(P, P + n):
            got.append(logits[:, -1])
            nxt = lm.delay_codes(logits[:, -1].argmax(-1), t, frames, V)
            seq = torch.cat([seq, nxt[..., None]], dim=-1)
            logits, caches = lm.decode_step_fn(cfg)(params, caches,
                                                    nxt[..., None], t)
        got.append(logits[:, -1])
    want, want_caches = ref.forward(params, seq, text)
    assert want.shape == (B, P + n, K, V)
    assert _rel(torch.stack(got, 1), want[:, P - 1:]) < REL
    for k in range(K):
        assert _rel(torch.stack(got, 1)[:, :, k], want[:, P - 1:, k]) < REL
    assert _cache_rel(caches, want_caches) < REL


def test_delay_codes_pads_each_codebook_before_and_after_its_frames():
    codes = torch.arange(K)[None].repeat(2, 1)          # codebook k gives k
    frames = 3
    rows = [lm.delay_codes(codes, t, frames, V)[0].tolist()
            for t in range(1, frames + K)]
    assert rows == [[0, V, V, V], [0, 1, V, V], [0, 1, 2, V],
                    [V, 1, 2, 3], [V, V, 2, 3], [V, V, V, 3]]


def _greedy_reference(params, codes, text, steps, frames):
    seq = codes
    for t in range(codes.shape[-1], codes.shape[-1] + steps):
        logits, _ = ref.forward(params, seq, text)
        nxt = logits[:, -1].argmax(-1)
        free = [k < t <= frames + k for k in range(K)]
        nxt = torch.where(torch.tensor(free), nxt, V)
        seq = torch.cat([seq, nxt[..., None]], dim=-1)
    return seq[..., codes.shape[-1]:]


def test_serve_loop_gives_the_reference_greedy_codes():
    """A 6-frame clip from the start code alone: 9 steps of 4 codes."""
    cfg = _cfg()
    params = _params(cfg, seed=5)
    start, text = _prompt(3, 1, seed=6)
    frames = 6
    steps = frames + K - 1
    out = serve.serve_loop(params, cfg, start, decode_steps=steps, text=text)
    assert out["tokens"].shape == (3, K, steps)
    want = _greedy_reference(params, start, text, steps, frames)
    assert torch.equal(out["tokens"], want)
    assert (out["tokens"] < V).sum() == 3 * K * frames


def test_serve_loop_refuses_the_zoo_stub_and_a_missing_text():
    from repro_torch.models import registry
    with pytest.raises(ValueError, match="embeddings"):
        serve.check_token_prompts(registry.get_config("musicgen-large"))
    cfg = _cfg()
    with pytest.raises(ValueError, match="text"):
        serve.serve_loop(_params(cfg), cfg, _prompt(1, 1)[0],
                         decode_steps=2)


def test_spans_and_counters_build_the_cross_cache_once():
    """`mixer.xattn` once a layer in prefill and in decode; `xattn.kv`
    and the counter `xattn.kv_built` once a layer in prefill, never in
    decode; `embed` and `logits` carry `codebooks`."""
    cfg = _cfg()
    params = _params(cfg)
    codes, text = _prompt(2, 5)
    with torch.inference_mode():
        tracing.start()
        logits, caches = lm.prefill_step_fn(cfg, capacity=8)(
            params, {"codes": codes, "text": text})
        pre, pre_c = tracing.stop()
        tracing.start()
        lm.decode_step_fn(cfg)(params, caches,
                               logits[:, -1].argmax(-1)[..., None], 5)
        dec, dec_c = tracing.stop()

    def count(spans, name):
        return sum(s["name"] == name for s in spans)

    assert count(pre, "mixer.xattn") == 2 and count(pre, "xattn.kv") == 2
    assert pre_c["xattn.kv_built"] == 2
    assert count(dec, "mixer.xattn") == 2 and count(dec, "xattn.kv") == 0
    assert "xattn.kv_built" not in dec_c
    for spans in (pre, dec):
        for name in ("embed", "logits"):
            s = next(s for s in spans if s["name"] == name)
            assert s["attrs"]["codebooks"] == K
    # attn.core nests in mixer.xattn
    xa = {i for i, s in enumerate(dec) if s["name"] == "mixer.xattn"}
    assert any(s["name"] == "attn.core" and s["parent"] in xa for s in dec)
    assert next(s for s in pre if s["name"] == "lm.prefill")["attrs"] == \
        {"batch": 2, "seq": 5}


def _fault_no_xattn(monkeypatch, cfg):
    monkeypatch.setattr(lm, "_xattn", lambda p, c, x, cache, src: x)
    return cfg


def _fault_codebook_left_out(monkeypatch, cfg):
    embed = lm._embed_tokens

    def fault(params, c, tokens, start=0):
        e = params["embed"].clone()
        e[-1] = 0
        return embed({**params, "embed": e}, c, tokens, start)

    monkeypatch.setattr(lm, "_embed_tokens", fault)
    return cfg


def _fault_rope(monkeypatch, cfg):
    return dataclasses.replace(cfg, positions="rope")


def _fault_layernorm_without_bias(monkeypatch, cfg):
    ln = L.layernorm
    monkeypatch.setattr(L, "layernorm", lambda p, x, eps=1e-5: ln(
        {"scale": p["scale"], "bias": torch.zeros_like(p["bias"])}, x, eps))
    return cfg


@pytest.mark.parametrize("fault", [
    _fault_no_xattn, _fault_codebook_left_out, _fault_rope,
    _fault_layernorm_without_bias],
    ids=["no-cross-attention", "codebook-left-out", "rope-not-sinusoid",
         "layernorm-without-bias"])
def test_each_planted_fault_fails_the_comparison(monkeypatch, fault):
    cfg = _cfg()
    params = _params(cfg)
    codes, text = _prompt(3, 12)
    cfg = fault(monkeypatch, cfg)
    logits_err, cache_err = _prefill_errs(cfg, params, codes, text)
    assert max(logits_err, cache_err) > 100 * REL


# bf16 against the f32 reference: 2 layers round the residual stream,
# the caches and the logits to bf16 (2^-8 relative, ~4e-3) at about a
# dozen points a layer, and N(0, 0.05) weights give the logits a wide
# spread: the worst of the 40 rows read 0.022 on an H100; the 48-layer
# cells read 0.019-0.020 at N(0, 0.02) and their fp8 control 0.1 and
# more. 4e-2 keeps twice the bf16 reading's room below the control.
CARD_REL = 4e-2


@pytest.mark.cuda
def test_two_published_layers_on_card_match_the_reference():
    """MusicGen-large's widths (d 2048, 32 heads of 64, ffn 8192, 4
    codebooks of 2048, text width 768), 2 layers, bf16, B=2, S=512, 64
    text states: prefill's last logits and caches, then 4 decode steps'
    logits, against the reference in f32 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    cfg = ModelConfig(
        name="musicgen-large-2", family="audio", d_model=2048,
        vocab_size=2048, num_heads=32, num_kv_heads=32, d_ff=8192,
        stacks=(Stack(("attn+mlp",), 2),), norm="layer", mlp="gelu",
        positions="sinusoidal", num_codebooks=4, cross_attn_dim=768,
        norm_eps=1e-5, use_pallas_attn=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _draw(lm.init_abstract(cfg), torch.Generator().manual_seed(0))
    params = _to(params, "cuda", torch.bfloat16)
    B, P, n = 2, 512, 4
    codes = torch.randint(0, 2048, (B, 4, P), generator=gen, device="cuda")
    for k in range(4):
        codes[:, k, :k + 1] = 2048
    text = torch.randn(B, 64, 768, generator=gen, device="cuda")
    got = []
    seq = codes
    with torch.inference_mode():
        logits, caches = lm.prefill_step_fn(cfg, capacity=P + n)(
            params, {"codes": codes, "text": text})
        for t in range(P, P + n):
            got.append(logits[:, -1].float())
            nxt = lm.delay_codes(logits[:, -1].argmax(-1), t, 10 ** 6, 2048)
            seq = torch.cat([seq, nxt[..., None]], dim=-1)
            logits, caches = lm.decode_step_fn(cfg)(params, caches,
                                                    nxt[..., None], t)
        got.append(logits[:, -1].float())
    want, want_caches = ref.forward(params, seq, text)
    for i, g in enumerate(got):
        for b in range(B):
            for k in range(4):
                assert _rel(g[b, k], want[b, P - 1 + i, k]) < CARD_REL
    assert _cache_rel(caches, want_caches) < CARD_REL


def _to(tree, device, dtype):
    """Norms and biases stay f32, as the port keeps its norms."""
    if isinstance(tree, dict):
        return {k: (v.to(device) if k in ("scale", "bias")
                    else _to(v, device, dtype)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device, dtype) for v in tree)
    return tree.to(device, dtype)
