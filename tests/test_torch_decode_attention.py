"""The decode step's attention route (`layers.cache_attention` through
`kernels.decode_attention`) on the CPU: its plain version is the port's
former `_cache_attention`, bit for bit, on the decode paths of four smoke
models; the caches those paths build hold no visible key at or beyond
the slot the kernel stops reading at; the split plan; and the counter
`attn.decode_kernel_calls`, which counts the calls sent to the kernel (0
on the CPU; its `cuda` case runs on the card). This file imports nothing
of JAX.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tracing
from repro_torch.kernels import decode_attention as dec
from repro_torch.models import layers as L
from repro_torch.models import lm, registry
from repro_torch.models.config import ModelConfig, Stack

K, V, T, DX = 4, 32, 8, 24


def _old_cache_attention(q, k_cache, v_cache, k_pos, pos, *, window):
    """`layers._cache_attention` as it was before the kernel, verbatim."""
    B, _, H, hd = q.shape
    C, KH = k_cache.shape[1], k_cache.shape[2]
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    qh = (q * L._scalar(scale, q)).reshape(B, KH, rep, hd)
    s = torch.einsum("bgrd,btgd->bgrt", qh.float(), k_cache.float())
    if k_pos is not None:
        valid = (k_pos >= 0) & (k_pos <= pos)
        if window is not None:
            valid = valid & (pos - k_pos < window)
        s = torch.where(valid[:, None, None, :], s, L.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _musicgen_cfg() -> ModelConfig:
    """MusicGen's decoder at a small size (as tests/test_torch_musicgen.py)."""
    return ModelConfig(
        name="musicgen-tiny", family="audio", d_model=64, vocab_size=V,
        num_heads=4, num_kv_heads=4, d_ff=128,
        stacks=(Stack(("attn+mlp",), 2),), norm="layer", mlp="gelu",
        positions="sinusoidal", num_codebooks=K, cross_attn_dim=DX,
        norm_eps=1e-5, dtype="float32", block_kv=4, use_pallas_attn=True)


def _params(cfg, seed=0):
    """Every leaf N(0, 0.05), norm scales 1 + N(0, 0.1): random enough
    that each layer's attention spreads over many slots."""
    gen = torch.Generator().manual_seed(seed)

    def draw(tree, key=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(draw(v, key) for v in tree)
        x = torch.randn(tree.shape, generator=gen, dtype=torch.float32)
        return (1 + 0.1 * x if key == "scale" else 0.05 * x).to(tree.dtype)
    return draw(lm.init_abstract(cfg))


def _decode(cfg, params, prompt: int, steps: int, batch: int = 2,
            device="cpu"):
    """Prefill `prompt` positions, then `steps` greedy decode steps;
    returns every step's logits."""
    g = torch.Generator().manual_seed(1)
    if cfg.num_codebooks:
        codes = torch.randint(0, V, (batch, K, prompt), generator=g)
        inputs = {"codes": codes.to(device),
                  "text": torch.randn(batch, T, DX, generator=g).to(device)}
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                          generator=g).to(device)}
    decode = lm.decode_step_fn(cfg)
    with torch.inference_mode():
        logits, cache = lm.prefill_step_fn(cfg, capacity=prompt + steps)(
            params, inputs)
        out = []
        for i in range(steps):
            nxt = logits[:, -1].argmax(-1)[..., None]   # [B,1] or [B,K,1]
            logits, cache = decode(params, cache, nxt, prompt + i)
            out.append(logits)
    return out


# (arch, prompt, decode steps): h2o and recurrentgemma decode past their
# 16-slot window, so their rings wrap inside the run
CASES = [("musicgen", 6, 5), ("granite-moe-3b-a800m", 9, 4),
         ("h2o-danube-3-4b", 12, 9), ("recurrentgemma-9b", 20, 5)]


def _case_cfg(arch):
    return _musicgen_cfg() if arch == "musicgen" else \
        registry.get_smoke_config(arch)


def _invisible(k_pos, pos, window):
    bad = (k_pos < 0) | (k_pos > pos)
    if window is not None:
        bad |= pos - k_pos >= window
    return bad


@pytest.mark.parametrize("arch,prompt,steps", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_route_is_the_former_cache_attention_bit_for_bit(
        monkeypatch, arch, prompt, steps):
    """Every decode call of the model's own path, recorded: the route's
    output equals the former function's on the same inputs, bit for bit;
    and no slot the kernel would not read (at or beyond n = min(pos + 1,
    C) with k_pos, none without) holds a visible key."""
    cfg = _case_cfg(arch)
    calls = []
    route = L.decode_attention

    def recording(q, k, v, k_pos, pos, *, window=None):
        out = route(q, k, v, k_pos, pos, window=window)
        calls.append((q.clone(), k.clone(), v.clone(),
                      None if k_pos is None else k_pos.clone(), pos, window,
                      out))
        return out
    monkeypatch.setattr(L, "decode_attention", recording)
    _decode(cfg, _params(cfg), prompt, steps)
    layers = sum(s.repeats * sum(not e.startswith("rglru")
                                 for e in s.pattern) for s in cfg.stacks)
    per_step = layers * (2 if cfg.cross_attn_dim else 1)
    assert len(calls) == steps * per_step
    wrapped = False
    for q, k, v, k_pos, pos, window, out in calls:
        assert torch.equal(out, _old_cache_attention(q, k, v, k_pos, pos,
                                                     window=window))
        C = k.shape[1]
        n = dec.read_slots(C, k_pos, pos)
        assert n == (C if k_pos is None else min(pos + 1, C))
        if k_pos is not None:
            assert bool(_invisible(k_pos[:, n:], pos, window).all())
            assert not bool(_invisible(k_pos[:, :n], pos, window).all())
            wrapped |= pos >= C
    assert wrapped == (arch in ("h2o-danube-3-4b", "recurrentgemma-9b"))


@pytest.mark.parametrize("window,prompt,capacity", [
    (None, 5, 12), (None, 12, 20), (4, 3, 12), (4, 4, 12), (4, 9, 12),
    (8, 20, 40)])
def test_no_visible_key_at_or_beyond_the_read_range(window, prompt,
                                                    capacity):
    """A cache built from a prefill of `prompt` positions, then decode
    writes up to its capacity (full: position p at slot p; ring: at
    p % C): after every write, each slot at or beyond n = min(pos + 1,
    C) is masked for the query at pos, and the written slot is seen."""
    cfg = dataclasses.replace(registry.get_smoke_config("h2o-danube-3-4b"),
                              sliding_window=window or 4096)
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(0)
    k = torch.randn(2, prompt, KH, hd, generator=g)
    cache = L.attn_make_cache_from_prefill(cfg, k, k.clone(), window=window,
                                           capacity=capacity)
    C = cache["k"].shape[1]
    assert C == (capacity if window is None else min(capacity, window))
    for pos in range(prompt, capacity):
        slot = pos % C if window is not None else pos
        cache["k_pos"][:, slot] = pos      # as attn_apply_decode writes
        n = dec.read_slots(C, cache["k_pos"], pos)
        assert bool(_invisible(cache["k_pos"][:, n:], pos, window).all())
        assert not bool(_invisible(cache["k_pos"][:, slot], pos,
                                   window).any())


def test_split_plan_fills_the_card_twice_with_long_enough_splits():
    """One split (one launch) once B * KH reaches 2 * SMs; below, enough
    splits to cover the SMs about twice, each of whole tiles, none
    empty, all n slots covered. The tile is 64 slots but where K and V
    of 64 padded rows pass the stage's bytes."""
    assert [dec.tile_slots(hd, 2) for hd in (8, 64, 120, 128, 256)] == \
        [64, 64, 64, 64, 32]
    assert [dec.tile_slots(hd, 4) for hd in (8, 64, 120, 128, 256)] == \
        [64, 64, 32, 32, 16]
    assert dec.plan(2048, 504, 64) == (1, 504)      # musicgen's decode
    assert dec.plan(264, 4096, 64) == (1, 4096)
    assert dec.plan(263, 4096, 64) == (2, 2048)
    assert dec.plan(32, 2048, 64) == (8, 256)       # granite at batch 4
    assert dec.plan(32, 545, 64) == (9, 64)         # h2o's serve loop
    assert dec.plan(4, 2048, 32) == (64, 32)        # recurrentgemma's ring
    assert dec.plan(8, 60, 64) == (1, 60)           # one tile
    for tile in (16, 32, 64):
        for bkh in (1, 7, 32, 100, 263, 264, 5000):
            for n in (1, 31, 64, 127, 255, 1000, 4097, 32768):
                splits, chunk = dec.plan(bkh, n, tile)
                assert (splits - 1) * chunk < n <= splits * chunk
                assert splits == 1 or (chunk % tile == 0
                                       and bkh * (splits - 1) < 2 * 132)
                assert (splits > 1) == (bkh < 264 and n > tile)


def test_plain_route_refuses_what_no_route_takes():
    """Shapes outside the function raise on the CPU too, and so do inputs
    that require grad while grad mode is on (neither route has a
    backward)."""
    q = torch.randn(1, 1, 6, 8)
    kv = torch.randn(1, 5, 4, 8)
    with pytest.raises(ValueError, match="H % KH"):
        dec.decode_attention(q, kv, kv, None, 0)
    with pytest.raises(ValueError, match="k_pos"):
        dec.decode_attention(q, kv[:, :, :2], kv[:, :, :2],
                             torch.zeros(1, 4, dtype=torch.int32), 0)
    qg = q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        dec.decode_attention(qg, kv[:, :, :2], kv[:, :, :2], None, 0)
    with torch.no_grad():
        assert dec.decode_attention(qg, kv[:, :, :2], kv[:, :, :2], None,
                                    0).shape == (1, 1, 6, 8)


def test_meta_tensors_take_the_plain_route():
    """The dry-run lowering decodes on meta tensors: they run the plain
    version (whose operations it counts), as CPU tensors do."""
    q = torch.empty(2, 1, 8, 16, device="meta")
    kv = torch.empty(2, 10, 4, 16, device="meta")
    k_pos = torch.empty(2, 10, dtype=torch.int32, device="meta")
    before = dec.launches
    out = dec.decode_attention(q, kv, kv, k_pos, 3, window=4)
    assert out.device.type == "meta" and out.shape == (2, 1, 8, 16)
    assert dec.launches == before


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_decode_kernel_calls_count_the_card_route(device):
    """`attn.decode_kernel_calls` over MusicGen's decode steps: 2 x layers
    a step on the card (self and cross attention, each a kernel call, as
    many kernel launches), 0 on the CPU, whose route is the plain
    version."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    cfg = _musicgen_cfg()
    params = _params(cfg)
    if device == "cuda":
        params = _to_cuda(params)
    steps = 3
    before = dec.launches
    tracing.start()
    try:
        _decode(cfg, params, 6, steps, device=device)
    finally:
        _, counters = tracing.stop()
    layers = cfg.stacks[0].repeats
    want = 2 * layers * steps if device == "cuda" else 0
    assert counters.get("attn.decode_kernel_calls", 0) == want
    assert dec.launches - before == want


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cuda(v) for v in tree)
    return tree.cuda()


def _chip_smoke():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "h2o-danube-3-4b",
                                  "recurrentgemma-9b"])
def test_chip_smokes_serve_capture_holds_the_loops_own_calls(monkeypatch,
                                                              arch):
    """`chip_smoke.py`'s `_decode_calls` keeps the serve loop's own
    decode-attention call at its position, with the output the loop got;
    `_hold_decode_calls` holds it against the plain version and fails on
    an output two bf16 ulps off; and `_ring_k_pos`, which builds the
    smoke's timed cases, is the k_pos the loop's cache holds there (h2o
    and recurrentgemma past their ring's wrap)."""
    from repro_torch.launch import serve
    cs = _chip_smoke()
    monkeypatch.setattr(dec, "_sm_count", lambda index: 132)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype="bfloat16")
    params = _params(cfg)
    prompt, steps, at = 12, 10, 17
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt),
                           generator=torch.Generator().manual_seed(2))
    with torch.inference_mode(), cs._decode_calls(at) as calls:
        serve.serve_loop(params, cfg, tokens, decode_steps=steps)
    assert len(calls) == 1
    (key, (q, k, v, k_pos, window, out)), = calls.items()
    C = k.shape[1]
    assert C == (min(prompt + steps, window) if window else prompt + steps)
    assert (at >= C) == (window is not None)
    assert torch.equal(k_pos, cs._ring_k_pos(2, C, at, "cpu"))
    assert cs._hold_decode_calls("test", calls, at) == 0.0
    tol = cs._decode_tol(out)
    calls[key] = (q, k, v, k_pos, window, out + 2 * tol)
    with pytest.raises(AssertionError, match="serve call"):
        cs._hold_decode_calls("test", calls, at)
