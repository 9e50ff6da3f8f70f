"""Layers of the LM zoo: RMSNorm, rotary embedding, GQA attention
(full-causal or sliding-window, optional qk-norm), DeepSeek-V3's
multi-head latent attention (MLA), the SwiGLU MLP, the token-choice MoE
ffn, the Mamba2 SSD mixer and RecurrentGemma's RG-LRU mixer; and, for
MusicGen's decoder (the port's own, not in the reference), LayerNorm,
sinusoidal positions, the two-matrix GELU MLP and cross-attention to a
conditioning sequence, whose keys and values prefill caches once.

Port of `repro.models.layers`. Parameters are dicts
of tensors laid out as the reference's pytrees. GQA and sliding-window
layers attend in train and prefill through `attend`: with the
hand-written flash-attention kernel (`repro_torch.kernels.flash_attention`)
when `cfg.use_pallas_attn` is set, else with `chunked_attention` (an
online softmax over KV blocks). The reference prefills with
`chunked_attention` whatever the flag says; the kernel computes the same
softmax. Decode attends over a cache (a ring buffer for sliding-window
layers) with `cache_attention`. MLA attends with `chunked_attention`
whatever the flag says, as the reference does, and decodes in the
absorbed form over its compressed cache (the KV latent and one rope key
per position).
The MoE ffn dispatches by a stable sort into per-expert capacity slots
and drops what overflows, as the reference does; its expert products are
batched matmuls. The SSD mixer takes the reference's chunked algorithm,
its inter-chunk `lax.scan` a Python loop over chunks; like the
reference it does not call the `ssd_scan` kernel. The RG-LRU's linear
recurrence mirrors `jax.lax.associative_scan`'s odd/even recursion, so
that it combines in the reference's order in about 2·log2(S) elementwise
passes, not a loop over S. The reference's sharding annotation of the
MoE dispatch buffer stays (`sharding.context.constrain(..., "moe_ecd")`):
the identity unless a dry-run lowers the step on DTensors under an
activation mapping.

Scalars that the reference casts to the activations' dtype before a
multiply (`q * scale`, the embedding's `sqrt(d_model)`) are cast here
too, so that bf16 rounds at the same points.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.hlo_import import loop
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.sharding.context import constrain

NEG_INF = -1e30


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` rounded to `like`'s dtype, as `jnp.asarray(value, dtype)`
    or a weakly typed Python scalar in JAX."""
    return torch.tensor(value, dtype=like.dtype)


def _norm_init(dim: int, lead: tuple = (), device="cpu") -> dict:
    return {"scale": torch.ones(lead + (dim,), dtype=torch.float32,
                                device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """`nn.LayerNorm` with weight `scale` and `bias`, in f32."""
    xf = x.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def norm_init(cfg: ModelConfig, lead: tuple = (), device="cpu") -> dict:
    """A block's or the final norm: RMSNorm's scale, and LayerNorm's
    bias beside it with `cfg.norm == "layer"`."""
    p = _norm_init(cfg.d_model, lead, device)
    if cfg.norm == "layer":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                                device=device)
    return p


def norm(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The config's norm (`cfg.norm`) of a block or of the final states."""
    if cfg.norm == "layer":
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def _winit(generator, shape, dtype, scale: float = 0.02,
           device="cpu") -> torch.Tensor:
    """N(0, 1) · scale drawn in f32 from `generator` (on its own device)
    and cast to `dtype` on `device`; shape-only on the meta device. The
    scale multiplies in place: a stacked leaf then needs its f32 draw
    and its cast beside it, not a second f32 copy."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(scale).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, H, hd] (hd even); positions: [S] absolute."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]          # [S, half]
    sin = torch.sin(ang)[None, :, None, :]
    cos = torch.cos(ang)[None, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[S, dim] f32 sinusoidal position embeddings of `positions` [S]
    (MusicGen's): cos half then sin half, frequency i of the `dim // 2`
    being 10000^(-i / (dim // 2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# ----------------------------------------------------------------------------
# Chunked online-softmax attention (train / prefill path)
# ----------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0, block_kv: int = 512) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,KH,hd] with H % KH == 0. Returns [B,S,H,hd].

    Walks KV blocks with a running (max, normalizer, accumulator): memory
    bounded by one block of scores. q is scaled in its own dtype before
    the f32 cast, as the reference does. Under a dry-run's activation
    mapping the queries split by position over the model axis and the
    keys and values are whole there (`constrain`; not in the reference,
    where GSPMD finds a layout, and the identity otherwise)."""
    with tracing.span("attn.core"):
        return _chunked_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, block_kv=block_kv)


def _chunked_attention(q, k, v, *, causal, window, q_offset, block_kv):
    tracing.count("attn.chunked_calls", 1)
    q = constrain(q, "attn_q")
    k = constrain(k, "attn_kv")
    v = constrain(v, "attn_kv")
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    qh = (q * _scalar(scale, q)).reshape(B, S, KH, rep, hd)
    qh = qh.float().permute(0, 2, 3, 1, 4)                 # [B,KH,rep,S,hd]

    blk = min(block_kv, T)
    nb = -(-T // blk)
    q_pos = q_offset + torch.arange(S, device=q.device)

    m = torch.full((B, KH, rep, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KH, rep, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, rep, S, hd), dtype=torch.float32,
                      device=q.device)
    for bi in loop(nb):
        # the last block may be ragged: the reference pads it with keys
        # that it masks, which changes no row that sees a key
        kq = k[:, bi * blk:(bi + 1) * blk].float()
        vq = v[:, bi * blk:(bi + 1) * blk].float()
        n = kq.shape[1]
        s = qh @ kq.permute(0, 2, 3, 1)[:, :, None]      # [B,KH,rep,S,n]
        k_pos = bi * blk + torch.arange(n, device=q.device)
        valid = torch.ones((S, n), dtype=torch.bool, device=q.device)
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = p @ vq.permute(0, 2, 1, 3)[:, :, None]       # [B,KH,rep,S,hd]
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, window: int | None,
           q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention of the train and prefill paths (`attn` and
    `swa` layers), q: [B,S,H,hd]; k,v: [B,T,KH,hd]. With
    `cfg.use_pallas_attn` the flash-attention kernel, counted as
    `attn.kernel_calls` (a shape it refuses raises); otherwise
    `chunked_attention` at `cfg.block_kv`. On a card the kernel's own
    launch counters (`flash_attention.launches`) count the same calls;
    this counter is the route's record on the CPU, where the kernel's
    plain version launches nothing, and in `tracing`'s counters."""
    with tracing.span("attn.core"):
        if cfg.use_pallas_attn:
            tracing.count("attn.kernel_calls", 1)
            return flash_attention(q, k, v, causal=True, window=window,
                                   q_offset=int(q_offset))
        return _chunked_attention(q, k, v, causal=True, window=window,
                                  q_offset=q_offset, block_kv=cfg.block_kv)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, k_pos: torch.Tensor | None,
                    pos: int, *, window: int | None = None) -> torch.Tensor:
    """Decode: q [B,1,H,hd] over cache [B,C,KH,hd]; k_pos [B,C] absolute
    positions of cached keys (-1 = empty slot), or None where every
    slot is seen (a cross-attention cache)."""
    with tracing.span("attn.core"):
        return _cache_attention(q, k_cache, v_cache, k_pos, pos,
                                window=window)


def _cache_attention(q, k_cache, v_cache, k_pos, pos, *, window):
    B, _, H, hd = q.shape
    C, KH = k_cache.shape[1], k_cache.shape[2]
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    qh = (q * _scalar(scale, q)).reshape(B, KH, rep, hd)
    s = torch.einsum("bgrd,btgd->bgrt", qh.float(), k_cache.float())
    if k_pos is not None:
        valid = (k_pos >= 0) & (k_pos <= pos)
        if window is not None:
            valid = valid & (pos - k_pos < window)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ----------------------------------------------------------------------------
# GQA attention block (mixers 'attn' and 'swa')
# ----------------------------------------------------------------------------
def attn_init(generator, cfg: ModelConfig, lead: tuple = (),
              device="cpu") -> dict:
    """One attention layer's weights, each with the leading axes `lead`
    (the stacked layers of a stack)."""
    D, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    H_pad = max(cfg.attn_pad_heads, H) if cfg.attn_pad_heads else H
    if H_pad % KH:
        raise ValueError(f"{H_pad} query heads do not split over {KH} "
                         "kv heads")
    dt = _dt(cfg)
    wq = _winit(generator, lead + (D, H_pad, hd), dt, device=device)
    wk = _winit(generator, lead + (D, KH, hd), dt, device=device)
    wv = _winit(generator, lead + (D, KH, hd), dt, device=device)
    wo = _winit(generator, lead + (H_pad, hd, D), dt,
                scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                device=device)
    if H_pad > H:
        # GQA maps head h -> kv group h // rep, so padding is PER GROUP
        # (last rep_pad - rep slots of each group), and the padded heads'
        # wo rows are zero: the function is the unpadded model's at init.
        rep, rep_pad = H // KH, H_pad // KH
        mask = torch.arange(H_pad, device=device) % rep_pad < rep
        wo = wo * mask[:, None, None].to(wo.dtype)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qk_norm:
        p["q_norm"] = _norm_init(hd, lead, device)
        p["k_norm"] = _norm_init(hd, lead, device)
    return p


def attn_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.positions == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply_train(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     window: int | None, q_offset: int = 0) -> torch.Tensor:
    B, S, D = x.shape
    positions = q_offset + torch.arange(S, device=x.device)
    q, k, v = attn_qkv(params, cfg, x, positions)
    out = attend(q, k, v, cfg, window=window, q_offset=q_offset)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def attn_cache_init(cfg: ModelConfig, batch: int, capacity: int, *,
                    window: int | None, lead: tuple = (),
                    device="cpu") -> dict:
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    C = min(capacity, window) if window is not None else capacity
    dt = _dt(cfg)
    return {
        "k": torch.zeros(lead + (batch, C, KH, hd), dtype=dt, device=device),
        "v": torch.zeros(lead + (batch, C, KH, hd), dtype=dt, device=device),
        "k_pos": torch.full(lead + (batch, C), -1, dtype=torch.int32,
                            device=device),
    }


def attn_apply_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict, pos: int, *,
                      window: int | None) -> tuple[torch.Tensor, dict]:
    """x: [B,1,D]; pos: absolute position of this token. Writes the new
    key and value into `cache` in place (the reference returns an updated
    copy) and returns (y, cache)."""
    # on the device without a host copy, which would wait for the card
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = attn_qkv(params, cfg, x, positions)
    C = cache["k"].shape[1]
    slot = pos % C if window is not None else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["k_pos"][:, slot] = pos
    out = cache_attention(q, cache["k"], cache["v"], cache["k_pos"], pos,
                          window=window)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def attn_make_cache_from_prefill(cfg: ModelConfig, k: torch.Tensor,
                                 v: torch.Tensor, *, window: int | None,
                                 capacity: int) -> dict:
    """Build a decode cache from prefill-computed k/v [B,S,KH,hd]."""
    B, S = k.shape[0], k.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=k.device)
    C = min(capacity, window) if window is not None else capacity
    kc = k.new_zeros((B, C) + k.shape[2:])
    vc = v.new_zeros((B, C) + v.shape[2:])
    kp = torch.full((B, C), -1, dtype=torch.int32, device=k.device)
    if window is not None:
        # keep the last C positions, placed at slot pos % C (ring layout)
        slots = (pos[-C:] % C).long()
        kc[:, slots] = k[:, -C:]
        vc[:, slots] = v[:, -C:]
        kp[:, slots] = pos[-C:]
    else:
        kc[:, :S] = k
        vc[:, :S] = v
        kp[:, :S] = pos
    return {"k": kc, "v": vc, "k_pos": kp}


# ----------------------------------------------------------------------------
# Cross-attention to a conditioning sequence (`cfg.cross_attn_dim`)
# ----------------------------------------------------------------------------
def xattn_init(generator, cfg: ModelConfig, lead: tuple = (),
               device="cpu") -> dict:
    """One block's cross-attention: `num_heads` query and key/value heads
    (MHA) over the projected conditioning states, no bias."""
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    dt = _dt(cfg)
    return {
        "wq": _winit(generator, lead + (D, H, hd), dt, device=device),
        "wk": _winit(generator, lead + (D, H, hd), dt, device=device),
        "wv": _winit(generator, lead + (D, H, hd), dt, device=device),
        "wo": _winit(generator, lead + (H, hd, D), dt,
                     scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                     device=device),
    }


def xattn_cache(params: dict, src: torch.Tensor) -> dict:
    """The block's cross cache from the projected conditioning states src
    [B,T,D]: keys `xk` and values `xv` [B,T,H,hd], built once a prefill
    (span `xattn.kv`, counter `xattn.kv_built`) and only read by decode."""
    with tracing.span("xattn.kv"):
        tracing.count("xattn.kv_built", 1)
        return {"xk": torch.einsum("btd,dhk->bthk", src, params["wk"]),
                "xv": torch.einsum("btd,dhk->bthk", src, params["wv"])}


def xattn_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, *, decode: bool) -> torch.Tensor:
    """x [B,S,D] (normed) attends to every position of the cross cache,
    unmasked: prefill through `chunked_attention`, decode through
    `cache_attention`."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if decode:
        out = cache_attention(q, cache["xk"], cache["xv"], None, 0)
    else:
        out = chunked_attention(q, cache["xk"], cache["xv"], causal=False,
                                block_kv=cfg.block_kv)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


# ----------------------------------------------------------------------------
# SwiGLU MLP, and the two-matrix GELU MLP (`cfg.mlp == "gelu"`)
# ----------------------------------------------------------------------------
def mlp_init(generator, cfg: ModelConfig, d_ff: int | None = None,
             lead: tuple = (), device="cpu") -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    dt = _dt(cfg)
    p = {} if cfg.mlp == "gelu" else {
        "w_gate": _winit(generator, lead + (D, F), dt, device=device)}
    p["w_up"] = _winit(generator, lead + (D, F), dt, device=device)
    p["w_down"] = _winit(generator, lead + (F, D), dt,
                         scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                         device=device)
    return p


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)                         # as jax.nn.silu


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = _silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def gelu_mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """W2 · GELU(W1 · x), the exact (erf) GELU, no gate and no bias."""
    return F.gelu(x @ params["w_up"]) @ params["w_down"]


# ----------------------------------------------------------------------------
# Token-choice MoE with sort-based dispatch
# ----------------------------------------------------------------------------
def moe_init(generator, cfg: ModelConfig, lead: tuple = (),
             device="cpu") -> dict:
    """One MoE ffn's weights: an f32 router in every dtype, the experts'
    stacked SwiGLU weights, `e_bias` for sigmoid routing and the shared
    experts' MLP where the config has them."""
    mc = cfg.moe
    D, E, Fe = cfg.d_model, mc.num_experts, mc.d_ff_expert
    dt = _dt(cfg)
    p = {
        "router": _winit(generator, lead + (D, E), torch.float32,
                         scale=0.006, device=device),
        "w_gate": _winit(generator, lead + (E, D, Fe), dt, device=device),
        "w_up": _winit(generator, lead + (E, D, Fe), dt, device=device),
        "w_down": _winit(generator, lead + (E, Fe, D), dt,
                         scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                         device=device),
    }
    if mc.router_scale:                      # deepseek aux-free bias routing
        p["e_bias"] = torch.zeros(lead + (E,), dtype=torch.float32,
                                  device=device)
    if mc.num_shared_experts:
        p["shared"] = mlp_init(generator, cfg,
                               mc.d_ff_shared * mc.num_shared_experts,
                               lead=lead, device=device)
    return p


def _route(params: dict, mc: MoEConfig, xf: torch.Tensor):
    """xf: [T, D] -> (gates [T,K], ids [T,K]), gates summing to 1. The
    router is f32 in every dtype."""
    logits = xf.float() @ params["router"]
    if mc.router_scale:
        scores = torch.sigmoid(logits)
        sel = scores + params["e_bias"][None, :]
        _, ids = torch.topk(sel, mc.top_k, dim=-1)
        gates = torch.gather(scores, -1, ids)
    else:
        gates, ids = torch.topk(torch.softmax(logits, dim=-1), mc.top_k,
                                dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def moe_capacity(tokens: int, mc: MoEConfig) -> int:
    """Slots per expert: ceil(T·K/E·cf), rounded up to a multiple of 8,
    at least 8 (Python arithmetic, as the reference's)."""
    cap = int(math.ceil(tokens * mc.top_k / mc.num_experts
                        * mc.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_dispatch(ids: torch.Tensor, num_experts: int, cap: int):
    """ids [T, K] -> (sort_idx, slot_sorted, keep) over the T·K (token,
    choice) pairs: a stable sort by expert keeps each expert's pairs in
    token order; pair j of the sort goes to slot expert·cap + its rank
    within its expert, or, past `cap`, to the sentinel slot E·cap and is
    dropped (`keep` False)."""
    flat_ids = ids.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    counts = torch.bincount(flat_ids, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(flat_ids.numel(),
                              device=ids.device) - starts[sorted_ids]
    keep = pos_sorted < cap
    slot_sorted = torch.where(keep, sorted_ids * cap + pos_sorted,
                              num_experts * cap)
    return sort_idx, slot_sorted, keep


def moe_dropped(params: dict, cfg: ModelConfig, x: torch.Tensor) -> int:
    """How many (token, choice) pairs of `x` [B,S,D] `moe_apply` drops at
    capacity."""
    mc = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    _, ids = _route(params, mc, xf)
    _, _, keep = moe_dispatch(ids, mc.num_experts,
                              moe_capacity(xf.shape[0], mc))
    return int((~keep).sum())


def moe_apply(params: dict, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """x: [B,S,D]. Sort-based dispatch with per-expert capacity + drop.
    The scatters write each slot once but the sentinel E·cap, which the
    dropped pairs share and which is thrown away, so their order under
    duplicate indices never matters.

    While `tracing` records, the counter `moe.experts_hit` gets the
    experts with at least one kept pair (those whose first slot is used:
    every expert with a pair keeps its first, since `cap` >= 8) and
    `moe.experts_read` the experts whose weights the expert products
    read: all E."""
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    K, E = mc.top_k, mc.num_experts
    xf = x.reshape(T, D)
    with tracing.span("moe.route"):
        gates, ids = _route(params, mc, xf)
    with tracing.span("moe.dispatch"):
        cap = moe_capacity(T, mc)
        sort_idx, slot_sorted, keep = moe_dispatch(ids, E, cap)
        tok_sorted = sort_idx // K
        dispatch_tok = torch.zeros(E * cap + 1, dtype=torch.long,
                                   device=x.device)
        dispatch_tok[slot_sorted] = tok_sorted
        slot_used = torch.zeros(E * cap + 1, dtype=torch.bool,
                                device=x.device)
        slot_used[slot_sorted] = keep
        xe = xf[dispatch_tok[:E * cap]] * slot_used[:E * cap, None]
        xe = constrain(xe.reshape(E, cap, D), "moe_ecd")
    if tracing.recording():
        tracing.count("moe.experts_hit", slot_used[:E * cap:cap])
        tracing.count("moe.experts_read", E)

    with tracing.span("moe.experts"):
        h = _silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(
            xe, params["w_up"])
        ye = torch.bmm(h, params["w_down"])
    with tracing.span("moe.combine"):
        ye_flat = torch.cat([ye.reshape(E * cap, D), ye.new_zeros((1, D))])
        # route outputs back to (token, k) order
        slot_of_flat = torch.empty(T * K, dtype=torch.long, device=x.device)
        slot_of_flat[sort_idx] = slot_sorted
        yk = ye_flat[slot_of_flat].reshape(T, K, D)
        out = torch.sum(yk * gates[..., None].to(yk.dtype), dim=1)

    if mc.num_shared_experts:
        with tracing.span("moe.shared"):
            out = out + mlp_apply(params["shared"], xf)
    return out.reshape(B, S, D).to(x.dtype)


# ----------------------------------------------------------------------------
# MLA — DeepSeek-V3 multi-head latent attention
# ----------------------------------------------------------------------------
def mla_init(generator, cfg: ModelConfig, lead: tuple = (),
             device="cpu") -> dict:
    """One MLA layer's weights: the query's low-rank down/up projections,
    the joint KV latent's down projection (latent + the shared rope key),
    its per-head up projections to k_nope and v, and wo."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dt = _dt(cfg)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": _winit(generator, lead + (D, m.q_lora_rank), dt,
                      device=device),
        "q_norm": _norm_init(m.q_lora_rank, lead, device),
        "wuq": _winit(generator, lead + (m.q_lora_rank, H, qk), dt,
                      device=device),
        "wdkv": _winit(generator, lead + (D, m.kv_lora_rank
                                          + m.qk_rope_head_dim), dt,
                       device=device),
        "kv_norm": _norm_init(m.kv_lora_rank, lead, device),
        "wuk": _winit(generator, lead + (m.kv_lora_rank, H,
                                         m.qk_nope_head_dim), dt,
                      device=device),
        "wuv": _winit(generator, lead + (m.kv_lora_rank, H, m.v_head_dim),
                      dt, device=device),
        "wo": _winit(generator, lead + (H, m.v_head_dim, D), dt,
                     scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                     device=device),
    }


def _mla_q(params: dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """x [B,S,D] -> (q_nope [B,S,H,nope], q_rope [B,S,H,rope])."""
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], x @ params["wdq"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wuq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor):
    """x [B,S,D] -> (ckv [B,S,kv_lora], the rope key shared by every head
    [B,S,rope]). The rope key is roped as a one-head [B,S,1,rope] view,
    as the reference's, so that its frequencies run over the last axis."""
    m = cfg.mla
    dkv = x @ params["wdkv"]
    ckv = rmsnorm(params["kv_norm"], dkv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = rope(dkv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    return ckv, k_rope[:, :, 0, :]


def mla_apply_train(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                    q_offset: int = 0) -> torch.Tensor:
    """x [B,S,D] -> [B,S,D]. q = [q_nope, q_rope] and k = [k_nope, k_rope
    broadcast over the heads], nope + rope columns each; v is zero-padded
    to that width so that `chunked_attention` applies (which scales q by
    1/sqrt of the padded width) and its output is sliced back before wo.
    As in the reference, MLA attends with `chunked_attention` whatever
    `cfg.use_pallas_attn` says."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    positions = q_offset + torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv, k_rope = _mla_kv_latent(params, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["wuk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, params["wuv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    v_p = F.pad(v, (0, qk - m.v_head_dim))
    out = chunked_attention(q, k, v_p, causal=True, q_offset=q_offset,
                            block_kv=cfg.block_kv)[..., :m.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def mla_cache_init(cfg: ModelConfig, batch: int, capacity: int,
                   lead: tuple = (), device="cpu") -> dict:
    """The compressed cache: the KV latent, the rope key and each slot's
    position (-1 = empty)."""
    m = cfg.mla
    dt = _dt(cfg)
    return {
        "ckv": torch.zeros(lead + (batch, capacity, m.kv_lora_rank),
                           dtype=dt, device=device),
        "krope": torch.zeros(lead + (batch, capacity, m.qk_rope_head_dim),
                             dtype=dt, device=device),
        "k_pos": torch.full(lead + (batch, capacity), -1, dtype=torch.int32,
                            device=device),
    }


def mla_apply_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """Absorbed-form decode, in the compressed latent space: wuk folds
    into the query (q_lat = q_nope·wuk, in the model's dtype, then f32),
    the scores are f32 products with the cached latent and rope key,
    scaled by 1/sqrt(nope + rope) after the sum, and the f32 context
    latent, cast to the model's dtype, goes through wuv and wo. x:
    [B,1,D]; writes the token's latent, rope key and position into
    `cache` at slot `pos` in place (the reference returns an updated
    copy) and returns (y [B,1,D], cache)."""
    m = cfg.mla
    # on the device without a host copy, which would wait for the card
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)       # [B,1,H,*]
    ckv_new, krope_new = _mla_kv_latent(params, cfg, x, positions)
    cache["ckv"][:, pos] = ckv_new[:, 0]
    cache["krope"][:, pos] = krope_new[:, 0]
    cache["k_pos"][:, pos] = pos
    ckv, krope, kp = cache["ckv"], cache["krope"], cache["k_pos"]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wuk"])[:, 0]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    with tracing.span("attn.core"):
        s = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv.float())
             + torch.einsum("bhk,btk->bht", q_rope[:, 0].float(),
                            krope.float())) * scale
        valid = (kp >= 0) & (kp <= pos)
        s = torch.where(valid[:, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bht,btr->bhr", p, ckv.float())
    v = torch.einsum("bhr,rhk->bhk", ctx_lat.to(_dt(cfg)), params["wuv"])
    y = torch.einsum("bhk,hkd->bd", v, params["wo"])[:, None, :]
    return y, cache


# ----------------------------------------------------------------------------
# SSD — Mamba2 mixer
# ----------------------------------------------------------------------------
def ssd_dims(cfg: ModelConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    H = d_inner // sc.head_dim
    return d_inner, H, sc.head_dim, sc.d_state


def ssd_init(generator, cfg: ModelConfig, lead: tuple = (),
             device="cpu") -> dict:
    sc = cfg.ssm
    D = cfg.d_model
    d_inner, H, P, N = ssd_dims(cfg)
    conv_dim = d_inner + 2 * sc.ngroups * N
    in_dim = 2 * d_inner + 2 * sc.ngroups * N + H
    dt = _dt(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": _winit(generator, lead + (D, in_dim), dt, device=device),
        "conv_w": _winit(generator, lead + (sc.conv_width, conv_dim),
                         torch.float32, 0.2, device=device),
        "conv_b": torch.zeros(lead + (conv_dim,), **f32),
        "A_log": torch.zeros(lead + (H,), **f32),         # a = -exp(A_log)
        "dt_bias": torch.full(lead + (H,), math.log(math.e - 1), **f32),
        "D_skip": torch.ones(lead + (H,), **f32),
        "y_norm": _norm_init(d_inner, lead, device),
        "w_out": _winit(generator, lead + (d_inner, D), dt,
                        scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                        device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: [B,S,C]; w: [W,C] (f32). Returns (y in
    x's dtype, new_state): the products and sums are f32 (bf16 x f32
    promotes, as in JAX); the state is the last W-1 inputs, in x's
    dtype."""
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(W))
    y = y + b[None, None, :]
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return y.to(x.dtype), new_state


def _ssd_split(cfg: ModelConfig, proj: torch.Tensor):
    """proj [..., in_dim] -> (z, xs, Bm, Cm, dt_raw)."""
    d_inner, H, _, N = ssd_dims(cfg)
    g = cfg.ssm.ngroups
    return torch.split(proj, [d_inner, d_inner, g * N, g * N, H], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))   # as jax.nn.softplus


def ssd_mix_chunked(cfg: ModelConfig, X, Bm, Cm, dlog, h0=None):
    """The SSD chunked algorithm. X: [B,S,H,P] inputs (already
    dt-scaled); Bm/Cm: [B,S,N] (ngroups=1); dlog: [B,S,H] per-step
    log-decay (<= 0). Returns (Y [B,S,H,P], final_state [B,H,N,P]), f32.
    The inter-chunk recurrence is a loop over chunks that hands each
    chunk the state before it (the reference's `lax.scan`)."""
    B_, S, H, P = X.shape
    N = Bm.shape[-1]
    L = min(cfg.ssm.chunk, S)
    nc = S // L
    if nc * L != S:
        raise ValueError(f"ssd_mix_chunked: S={S} is not a multiple of "
                         f"the chunk {L}")
    Xc = X.reshape(B_, nc, L, H, P).float()
    Bc = Bm.reshape(B_, nc, L, N).float()
    Cc = Cm.reshape(B_, nc, L, N).float()
    cum = torch.cumsum(dlog.reshape(B_, nc, L, H), dim=2)     # [B,nc,L,H]

    # intra-chunk (masked decay attention)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,L,L,H]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=X.device))
    dec = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    del seg
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    att = scores[..., None] * dec                             # [B,nc,L,L,H]
    del dec
    Y_intra = torch.einsum("bclsh,bcshp->bclhp", att, Xc)
    del att

    # per-chunk input state contribution
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # [B,nc,L,H]
    S_state = torch.einsum("bcln,bclh,bclhp->bchnp", Bc, decay_to_end,
                           Xc)                                # [B,nc,H,N,P]

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # [B,nc,H]
    h = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=X.device)
         if h0 is None else h0.float())
    before = []
    for c in loop(nc):
        before.append(h)                                      # state BEFORE
        h = h * chunk_decay[:, c, :, None, None] + S_state[:, c]
    h_before = torch.stack(before, dim=1)                     # [B,nc,H,N,P]

    Y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, torch.exp(cum),
                           h_before)
    Y = (Y_intra + Y_inter).reshape(B_, S, H, P)
    return Y, h


def _ssd_conv_inputs(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     conv_state):
    """The shared front of train and decode: in-projection, causal conv
    and its silu, dt. Returns (z, xs, Bm, Cm, dt f32, new conv state)."""
    d_inner, _, _, N = ssd_dims(cfg)
    gN = cfg.ssm.ngroups * N
    z, xs, Bm, Cm, dt_raw = _ssd_split(cfg, x @ params["w_in"])
    conv_out, new_conv = _causal_conv(torch.cat([xs, Bm, Cm], dim=-1),
                                      params["conv_w"], params["conv_b"],
                                      conv_state)
    conv_out = _silu(conv_out)
    xs = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + gN]
    Cm = conv_out[..., d_inner + gN:]
    dt = _softplus(dt_raw.float() + params["dt_bias"])
    return z, xs, Bm, Cm, dt, new_conv


def _ssd_out(params: dict, cfg: ModelConfig, Y: torch.Tensor,
             z: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    y = Y.reshape(z.shape).to(like.dtype)
    y = rmsnorm(params["y_norm"], y * _silu(z), cfg.norm_eps)
    return y @ params["w_out"]


def ssd_apply_train(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    conv_state=None, h0=None, return_state: bool = False):
    """x: [B,S,D] -> [B,S,D]; with `return_state`, also the decode cache
    {"state": f32 [B,H,N,P], "conv": the last W-1 conv inputs in x's
    dtype}. S is padded up to a multiple of the chunk with state-neutral
    steps (B = 0: no input; dlog = 0: no decay)."""
    B, S, _ = x.shape
    _, H, P, _ = ssd_dims(cfg)
    z, xs, Bm, Cm, dt, new_conv = _ssd_conv_inputs(params, cfg, x,
                                                   conv_state)
    a = -torch.exp(params["A_log"])                           # [H], negative
    dlog = dt * a[None, None, :]                              # [B,S,H]
    X = xs.reshape(B, S, H, P)
    U = X.float() * dt[..., None]
    L = min(cfg.ssm.chunk, S)
    pad = (-S) % L
    if pad:
        Y, hT = ssd_mix_chunked(
            cfg, F.pad(U, (0, 0, 0, 0, 0, pad)), F.pad(Bm, (0, 0, 0, pad)),
            F.pad(Cm, (0, 0, 0, pad)), F.pad(dlog, (0, 0, 0, pad)), h0)
        Y = Y[:, :S]
    else:
        Y, hT = ssd_mix_chunked(cfg, U, Bm, Cm, dlog, h0)
    Y = Y + params["D_skip"][None, None, :, None] * X.float()
    out = _ssd_out(params, cfg, Y, z, x)
    if return_state:
        return out, {"state": hT.float(), "conv": new_conv}
    return out


def ssd_cache_init(cfg: ModelConfig, batch: int, lead: tuple = (),
                   device="cpu") -> dict:
    sc = cfg.ssm
    d_inner, H, P, N = ssd_dims(cfg)
    conv_dim = d_inner + 2 * sc.ngroups * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "state": torch.zeros(lead + (batch, H, N, P), **f32),
        "conv": torch.zeros(lead + (batch, sc.conv_width - 1, conv_dim),
                            **f32),
    }


def ssd_apply_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """Single-token state update; x: [B,1,D]; `pos` is not used. Writes
    the new state and conv inputs into `cache` in place (the reference
    returns them) and returns (y, cache). The conv inputs keep the
    cache's dtype: an f32 cache from `ssd_cache_init` holds a bf16
    model's inputs exactly, where the reference's would turn bf16."""
    del pos
    B = x.shape[0]
    d_inner, H, P, _ = ssd_dims(cfg)
    z, xs, Bm, Cm, dt, new_conv = _ssd_conv_inputs(params, cfg, x,
                                                   cache["conv"])
    Bm, Cm, dt = Bm[:, 0], Cm[:, 0], dt[:, 0]
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a[None, :])                        # [B,H]
    X = xs.reshape(B, H, P).float()
    U = X * dt[..., None]
    state = cache["state"] * decay[..., None, None] + \
        torch.einsum("bn,bhp->bhnp", Bm.float(), U)
    Y = torch.einsum("bn,bhnp->bhp", Cm.float(), state)
    Y = Y + params["D_skip"][None, :, None] * X
    cache["state"].copy_(state)
    cache["conv"].copy_(new_conv)
    return _ssd_out(params, cfg, Y, z, x), cache


# ----------------------------------------------------------------------------
# RG-LRU: RecurrentGemma's recurrent mixer
# ----------------------------------------------------------------------------
def rglru_init(generator, cfg: ModelConfig, lead: tuple = (),
               device="cpu") -> dict:
    rc = cfg.rglru
    D = cfg.d_model
    W = rc.lru_width or D
    dt = _dt(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_x": _winit(generator, lead + (D, W), dt, device=device),
        "w_gate": _winit(generator, lead + (D, W), dt, device=device),
        "conv_w": _winit(generator, lead + (rc.conv_width, W),
                         torch.float32, 0.2, device=device),
        "conv_b": torch.zeros(lead + (W,), **f32),
        "w_rg": _winit(generator, lead + (W, W), dt, device=device),
        "w_ig": _winit(generator, lead + (W, W), dt, device=device),
        "lam": torch.full(lead + (W,), 2.2, **f32),       # a ~ 0.9 at init
        "w_out": _winit(generator, lead + (W, D), dt,
                        scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                        device=device),
    }


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[B, n_e, W] and [B, n_o, W] (n_e = n_o or n_o + 1) -> [B, n_e +
    n_o, W] with `even` at positions 0, 2, ... (jax's `_interleave`)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n \
        else out


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) along axis 1 under combine((a1, b1),
    (a2, b2)) = (a1·a2, a2·b1 + b2), by `jax.lax.associative_scan`'s
    recursion: combine adjacent pairs, scan those, then combine each odd
    result with the next even element; so each h_t takes the reference's
    products in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_even, b_even = a[:, 0:-1:2], b[:, 0:-1:2]
    a_odd, b_odd = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _assoc_scan(a_even * a_odd, a_odd * b_even + b_odd)
    a_next, b_next = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        ea, eb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        ea, eb = odd_a, odd_b
    even_a = torch.cat([a[:, :1], ea * a_next], dim=1)
    even_b = torch.cat([b[:, :1], a_next * eb + b_next], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t-1} + b_t over S. log_a, b: [B,S,W]; h0
    [B,W] folds into the first step, as the reference folds it."""
    a = torch.exp(log_a)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _assoc_scan(a, b)[1]


def rglru_core(params: dict, cfg: ModelConfig, x: torch.Tensor,
               conv_state=None, h0=None):
    """x: [B,S,D] -> (y [B,S,D], the new conv state: the last W-1 conv
    inputs in x's dtype, h at the last step f32 [B,W]). The projections
    stay in x's dtype; the conv output, cast to x's dtype, takes the two
    gate products in f32."""
    rc = cfg.rglru
    u = x @ params["w_x"]
    gate = x @ params["w_gate"]
    conv_out, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                                      conv_state)
    uc = conv_out.float()
    r = torch.sigmoid(uc @ params["w_rg"].float())
    i = torch.sigmoid(uc @ params["w_ig"].float())
    log_a = -rc.c_exponent * _softplus(params["lam"]) * r      # [B,S,W]
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    h = _rglru_scan(log_a, beta * (i * uc), h0)
    y = h.to(x.dtype) * _silu(gate)
    return y @ params["w_out"], new_conv, h[:, -1]


def rglru_apply_train(params: dict, cfg: ModelConfig,
                      x: torch.Tensor) -> torch.Tensor:
    return rglru_core(params, cfg, x)[0]


def rglru_cache_init(cfg: ModelConfig, batch: int, lead: tuple = (),
                     device="cpu") -> dict:
    rc = cfg.rglru
    W = rc.lru_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"state": torch.zeros(lead + (batch, W), **f32),
            "conv": torch.zeros(lead + (batch, rc.conv_width - 1, W), **f32)}


def rglru_apply_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """One token; x: [B,1,D]; `pos` is not used. Writes the new state and
    conv inputs into `cache` in place (the reference returns them) and
    returns (y, cache). The conv inputs keep the cache's dtype: an f32
    cache from `rglru_cache_init` holds a bf16 model's inputs exactly,
    where the reference's would turn bf16 (as `ssd_apply_decode`)."""
    del pos
    out, new_conv, h_last = rglru_core(params, cfg, x,
                                       conv_state=cache["conv"],
                                       h0=cache["state"])
    cache["state"].copy_(h_last)
    cache["conv"].copy_(new_conv)
    return out, cache
