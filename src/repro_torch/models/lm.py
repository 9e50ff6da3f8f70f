"""Generic LM assembled from config stacks: `repro.models.lm` for the
mixers `attn`, `swa`, `mla`, `ssd` and `rglru` and the ffns `mlp`, `moe`
and `none`, with the frame-embedding (`cfg.embed_inputs`) and
patch-prefix (`cfg.num_patch_tokens`) front ends. It runs all ten archs
of the zoo: h2o-danube-3-4b, yi-9b, yi-34b, qwen3-14b,
granite-moe-3b-a800m, deepseek-v3-671b, musicgen-large, llava-next-34b,
mamba2-2.7b and recurrentgemma-9b. Beyond the reference, the port's own
config fields run MusicGen's decoder as published (prefill and decode):
LayerNorm blocks (`cfg.norm`), the GELU MLP (`cfg.mlp`), sinusoidal
positions (`cfg.positions`), K codebooks in and K heads out
(`cfg.num_codebooks`; `delay_codes` is its delay pattern) and
cross-attention to text states (`cfg.cross_attn_dim`: `enc_to_dec`
projects them, each block caches their keys and values at prefill).

Parameters keep the reference's tree: `embed`, `final_norm`, `lm_head`
(unless tied) and `stacks`, a list with one entry per stack, each a
tuple with one dict per pattern element whose leaves carry a leading
`[repeats]` axis (the reference's `vmap` over layer keys). The
reference scans the stacked layers with `jax.lax.scan`; the port loops
over them in Python, through `core.hlo_import.scan`, a plain loop unless
the importer records (`cfg.scan_layers` and `cfg.scan_microbatch`, the
reference's switch between a scan and an unrolled loop, name the same
loop here and change nothing). In a differentiated forward each layer is
rematerialized, `torch.utils.checkpoint(..., use_reentrant=False)`,
unless `cfg.remat == "none"`; the reference's `"dots"` policy (keep the
products without batch dims, recompute the rest) has no torch
counterpart that tells those products apart, so it takes full remat.
Remat changes no number. Caches are stacked the same way; decode updates
them in place.

Entry points:
  init_params(generator, cfg, device)   — random params at the
                                          reference's init scales
  init_abstract(cfg)                    — the same tree on the meta
                                          device: shapes, no allocation
  forward_trunk / logits_fn / loss_fn   — the train/score forward
  make_optimizer(cfg) / train_step_fn(cfg)
                                        — AdamW or Adafactor, the
                                          microbatched train step
  prefill_step_fn(cfg, capacity)        — (params, batch) -> (logits, cache)
  decode_step_fn(cfg)                   — (params, cache, tokens, pos) -> ...
  init_cache / cache_abstract           — decode caches, real or on
                                          the meta device
  analytic_param_count(cfg)             — the count from the abstract
                                          tree (671,026,419,200 for
                                          deepseek-v3-671b)
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.core import hlo_import
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.context import constrain, constrain_batch_tree
from repro_torch.training.adafactor import adafactor_init, \
    adafactor_update_
from repro_torch.training.optim import AdamWConfig, adamw_init, \
    adamw_update_, divide, tree_leaves, tree_map, tree_unflatten

_MIXERS = ("attn", "swa", "mla", "ssd", "rglru")
# span names, built once: a span site then passes a constant
_MIXER_SPAN = {m: f"mixer.{m}" for m in _MIXERS}
_FFN_SPAN = {"mlp": "ffn.mlp", "moe": "ffn.moe"}


def _parse(elem: str) -> tuple[str, str]:
    if "+" in elem:
        m, f = elem.split("+", 1)
    else:
        m, f = elem, "none"
    return m, f


def _check_elem(elem: str) -> tuple[str, str]:
    mixer, ffn = _parse(elem)
    if mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"unknown ffn {ffn!r}")
    return mixer, ffn


def _mixer_window(cfg: ModelConfig, mixer: str) -> int | None:
    return cfg.sliding_window if mixer == "swa" else None


def _index(tree, i: int):
    """Layer i of a stacked tree (every leaf's leading axis)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    """Stack per-layer trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ----------------------------------------------------------------------------
# Block init / apply
# ----------------------------------------------------------------------------
def block_init(generator, cfg: ModelConfig, elem: str, lead: tuple = (),
               device="cpu") -> dict:
    mixer, ffn = _check_elem(elem)
    p: dict[str, Any] = {"norm1": L.norm_init(cfg, lead, device)}
    if mixer == "mla":
        p["mixer"] = L.mla_init(generator, cfg, lead, device)
    elif mixer == "ssd":
        p["mixer"] = L.ssd_init(generator, cfg, lead, device)
    elif mixer == "rglru":
        p["mixer"] = L.rglru_init(generator, cfg, lead, device)
    else:
        p["mixer"] = L.attn_init(generator, cfg, lead, device)
    if cfg.cross_attn_dim:
        p["norm_x"] = L.norm_init(cfg, lead, device)
        p["xattn"] = L.xattn_init(generator, cfg, lead, device)
    if ffn != "none":
        p["norm2"] = L.norm_init(cfg, lead, device)
        p["ffn"] = (L.mlp_init(generator, cfg, lead=lead, device=device)
                    if ffn == "mlp"
                    else L.moe_init(generator, cfg, lead, device))
    return p


def _ffn(params: dict, cfg: ModelConfig, ffn: str,
         x: torch.Tensor) -> torch.Tensor:
    if ffn != "none":
        with tracing.span(_FFN_SPAN[ffn]):
            h = L.norm(params["norm2"], cfg, x)
            if ffn == "moe":
                x = x + L.moe_apply(params["ffn"], cfg, h)
            elif cfg.mlp == "gelu":
                x = x + L.gelu_mlp_apply(params["ffn"], h)
            else:
                x = x + L.mlp_apply(params["ffn"], h)
    return x


def _xattn(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
           src: torch.Tensor | None) -> torch.Tensor:
    """x plus the block's cross-attention (`cfg.cross_attn_dim`), under
    the span `mixer.xattn`. With `src`, the projected conditioning
    states of a prefill, it first builds the block's cross cache into
    `cache`; decode passes None and reads the cache prefill built."""
    if not cfg.cross_attn_dim:
        return x
    with tracing.span("mixer.xattn"):
        if src is not None:
            cache.update(L.xattn_cache(params["xattn"], src))
        h = L.norm(params["norm_x"], cfg, x)
        return x + L.xattn_apply(params["xattn"], cfg, h, cache,
                                 decode=src is None)


def block_apply_train(params: dict, cfg: ModelConfig, elem: str,
                      x: torch.Tensor) -> torch.Tensor:
    mixer, ffn = _check_elem(elem)
    h = L.norm(params["norm1"], cfg, x)
    if mixer == "mla":
        h = L.mla_apply_train(params["mixer"], cfg, h)
    elif mixer == "ssd":
        h = L.ssd_apply_train(params["mixer"], cfg, h)
    elif mixer == "rglru":
        h = L.rglru_apply_train(params["mixer"], cfg, h)
    else:
        h = L.attn_apply_train(params["mixer"], cfg, h,
                               window=_mixer_window(cfg, mixer))
    # the mixer's output as the block's (not in the reference: DTensor
    # would otherwise carry its pending sum over "model" into the ffn)
    h = constrain(h, "act_btd")
    return constrain(_ffn(params, cfg, ffn, x + h), "act_btd")


def block_cache_init(cfg: ModelConfig, elem: str, batch: int,
                     capacity: int, lead: tuple = (), device="cpu") -> dict:
    mixer, _ = _check_elem(elem)
    if mixer == "mla":
        return L.mla_cache_init(cfg, batch, capacity, lead, device)
    if mixer == "ssd":
        return L.ssd_cache_init(cfg, batch, lead, device)
    if mixer == "rglru":
        return L.rglru_cache_init(cfg, batch, lead, device)
    return L.attn_cache_init(cfg, batch, capacity,
                             window=_mixer_window(cfg, mixer), lead=lead,
                             device=device)


def block_apply_decode(params: dict, cfg: ModelConfig, elem: str,
                       x: torch.Tensor, cache: dict, pos: int) -> tuple:
    mixer, ffn = _check_elem(elem)
    h = L.norm(params["norm1"], cfg, x)
    with tracing.span(_MIXER_SPAN[mixer]):
        if mixer == "mla":
            h, new_cache = L.mla_apply_decode(params["mixer"], cfg, h, cache,
                                              pos)
        elif mixer == "ssd":
            h, new_cache = L.ssd_apply_decode(params["mixer"], cfg, h, cache,
                                              pos)
        elif mixer == "rglru":
            h, new_cache = L.rglru_apply_decode(params["mixer"], cfg, h,
                                                cache, pos)
        else:
            h, new_cache = L.attn_apply_decode(
                params["mixer"], cfg, h, cache, pos,
                window=_mixer_window(cfg, mixer))
    x = _xattn(params, cfg, x + h, cache, None)
    return _ffn(params, cfg, ffn, x), new_cache


def block_apply_prefill(params: dict, cfg: ModelConfig, elem: str,
                        x: torch.Tensor, capacity: int,
                        xsrc: torch.Tensor | None = None) -> tuple:
    """Like train, but also returns the decode cache for this layer.
    GQA and sliding-window layers attend as in train (`layers.attend`:
    the flash kernel with `use_pallas_attn`, where the reference keeps
    `chunked_attention`); MLA attends with `chunked_attention`. With
    `cfg.cross_attn_dim`, `xsrc` is the projected conditioning states
    [B,T,D], whose keys and values join the cache (`xk`, `xv`)."""
    mixer, ffn = _check_elem(elem)
    h = L.norm(params["norm1"], cfg, x)
    with tracing.span(_MIXER_SPAN[mixer]):
        h, cache = _mixer_prefill(params["mixer"], cfg, mixer, h, capacity)
    x = _xattn(params, cfg, x + h, cache, xsrc)
    return _ffn(params, cfg, ffn, x), cache


def _mixer_prefill(params: dict, cfg: ModelConfig, mixer: str,
                   h: torch.Tensor, capacity: int) -> tuple:
    """The mixer's output over the normed input `h` and its decode
    cache."""
    if mixer == "mla":
        # the latent for the cache, then the train path, which computes
        # it again (as the reference does); both padded to `capacity`
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device)
        ckv, krope = L._mla_kv_latent(params, cfg, h, positions)
        pad = capacity - S
        cache = {"ckv": F.pad(ckv, (0, 0, 0, pad)),
                 "krope": F.pad(krope, (0, 0, 0, pad)),
                 "k_pos": F.pad(positions.to(torch.int32).expand(B, S),
                                (0, pad), value=-1)}
        return L.mla_apply_train(params, cfg, h), cache
    if mixer == "ssd":
        return L.ssd_apply_train(params, cfg, h, return_state=True)
    if mixer == "rglru":
        h, conv, h_last = L.rglru_core(params, cfg, h)
        return h, {"state": h_last.float(), "conv": conv}
    window = _mixer_window(cfg, mixer)
    positions = torch.arange(h.shape[1], device=h.device)
    q, k, v = L.attn_qkv(params, cfg, h, positions)
    out = L.attend(q, k, v, cfg, window=window)
    h = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return h, L.attn_make_cache_from_prefill(cfg, k, v, window=window,
                                             capacity=capacity)


# ----------------------------------------------------------------------------
# Whole-model params
# ----------------------------------------------------------------------------
def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                device="cuda") -> dict:
    """Random params at the reference's init scales, drawn from
    `generator` (its numbers are not JAX's: carry the reference's own
    params across with `repro_torch.models.params.lm_from_jax_params`).
    On the meta device it gives the shapes alone, with no generator."""
    dev = resolve_device(device)
    for stack in cfg.stacks:
        for elem in stack.pattern:
            _check_elem(elem)
    dt = L._dt(cfg)
    K = cfg.num_codebooks
    if K and cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: codebook heads are not tied")
    # K codebooks: K tables of vocab_size + 1 rows (the pad/start id) and
    # K heads, stacked
    embed = (K, cfg.vocab_size + 1, cfg.d_model) if K \
        else (cfg.vocab_size, cfg.d_model)
    params: dict[str, Any] = {
        "embed": L._winit(generator, embed, dt, device=dev),
        "final_norm": L.norm_init(cfg, device=dev),
    }
    if not cfg.tie_embeddings:
        head = (cfg.d_model, cfg.vocab_size)
        params["lm_head"] = L._winit(generator, (K,) + head if K else head,
                                     dt, device=dev)
    if cfg.cross_attn_dim:
        # the conditioning states' projection to d_model (with a bias)
        params["enc_to_dec"] = {
            "w": L._winit(generator, (cfg.cross_attn_dim, cfg.d_model), dt,
                          device=dev),
            "b": torch.zeros(cfg.d_model, dtype=dt, device=dev)}
    params["stacks"] = [
        tuple(block_init(generator, cfg, elem, (stack.repeats,), dev)
              for elem in stack.pattern)
        for stack in cfg.stacks]
    return params


def init_abstract(cfg: ModelConfig) -> dict:
    """`init_params`' tree on the meta device: every leaf's shape and
    dtype, nothing allocated, no generator (the reference's
    `jax.eval_shape` of its init)."""
    return init_params(None, cfg, device="meta")


# ----------------------------------------------------------------------------
# Forward (training / prefill trunk)
# ----------------------------------------------------------------------------
def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                  start: int = 0) -> torch.Tensor:
    """Token ids [B,S] -> the scaled embeddings; codes [B,K,S] with
    `cfg.num_codebooks` -> the sum of the K codebooks' embeddings, in
    f32, rounded once to the model's dtype. Sinusoidal positions
    (`cfg.positions`), from position `start`, join that f32 sum."""
    if not cfg.num_codebooks:
        tok = params["embed"][tokens.long()]
        tok = tok * L._scalar(math.sqrt(cfg.d_model), tok)
        if cfg.positions != "sinusoidal":
            return tok
        x = tok.float()
    else:
        x = sum(params["embed"][k][tokens[:, k].long()].float()
                for k in range(cfg.num_codebooks))
    pos = start + torch.arange(tokens.shape[-1], device=tokens.device)
    return (x + L.sinusoid(pos, cfg.d_model)).to(L._dt(cfg))


def _cross_source(params, cfg: ModelConfig,
                 text: torch.Tensor) -> torch.Tensor:
    """The conditioning states [B,T,cross_attn_dim] projected to d_model
    in the model's dtype (MusicGen's `enc_to_dec_proj`)."""
    p = params["enc_to_dec"]
    return text.to(p["w"].dtype) @ p["w"] + p["b"]


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The trunk's input [B,S,D]: musicgen's frame embeddings
    (`batch["embeddings"]`) in the model's dtype; with codebooks the
    summed embeddings of `batch["codes"]` [B,K,S]; else the scaled token
    embeddings, after llava's patch embeddings (`batch["patch_embeds"]`,
    [B,P,D], cast to the tokens' dtype) where the config has them."""
    if cfg.embed_inputs:
        return constrain(batch["embeddings"].to(L._dt(cfg)), "act_btd")
    if cfg.num_codebooks:
        return constrain(_embed_tokens(params, cfg, batch["codes"]),
                         "act_btd")
    tok = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.num_patch_tokens:
        tok = torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    return constrain(tok, "act_btd")


def forward_trunk(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B,S,D] embeddings -> final hidden states. Under grad mode each
    layer is rematerialized unless `cfg.remat == "none"`. Configs with
    cross-attention run prefill and decode only."""
    if cfg.cross_attn_dim:
        raise NotImplementedError(f"{cfg.name}: cross-attention blocks run "
                                  "through prefill_step_fn and "
                                  "decode_step_fn only")
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for stack, elem_params in zip(cfg.stacks, params["stacks"]):
        for layer in hlo_import.scan(elem_params, stack.repeats):
            for elem, p in zip(stack.pattern, layer):
                if remat:
                    x = checkpoint(block_apply_train, p, cfg, elem, x,
                                   use_reentrant=False)
                else:
                    x = block_apply_train(p, cfg, elem, x)
    return L.norm(params["final_norm"], cfg, x)


def logits_fn(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h [B,S,D] -> logits [B,S,V], or [B,S,K,V] with K codebooks."""
    if cfg.num_codebooks:
        return torch.einsum("bsd,kdv->bskv", h, params["lm_head"])
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def loss_fn(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch, f32 scalar. With
    frame embeddings every position is scored against `batch["labels"]`
    (no shift); with a patch prefix of P positions, logits[:, P:-1]
    against tokens[:, 1:]."""
    x = _embed_inputs(params, cfg, batch)
    h = forward_trunk(params, cfg, x)
    logits = logits_fn(params, cfg, h).float()
    if cfg.embed_inputs:
        lg, labels = logits, batch["labels"].long()
    else:
        off = cfg.num_patch_tokens
        lg = logits[:, off:-1]
        labels = batch["tokens"][:, 1:].long()
    logp = torch.log_softmax(lg, dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ----------------------------------------------------------------------------
# Train step (microbatched gradient accumulation)
# ----------------------------------------------------------------------------
def make_optimizer(cfg: ModelConfig, optim_cfg: AdamWConfig | None = None):
    """(init, update) for `cfg.optimizer`: AdamW (the reference's default
    `AdamWConfig(lr=3e-4, weight_decay=0.1, schedule="cosine")`) or
    Adafactor at `optim_cfg.lr`. `update(params, grads, state)` writes
    the new parameters and state in place (run it under no_grad) and
    returns (params, state, stats)."""
    optim_cfg = optim_cfg or AdamWConfig(lr=3e-4, weight_decay=0.1,
                                         schedule="cosine")
    if cfg.optimizer == "adafactor":
        return (adafactor_init,
                lambda p, g, s: adafactor_update_(p, g, s, lr=optim_cfg.lr))
    return (adamw_init,
            lambda p, g, s: adamw_update_(p, g, s, optim_cfg))


def split_microbatches(batch: dict, n_micro: int) -> list[dict]:
    """The global batch as `n_micro` microbatches: [n_micro, mb, ...]
    views, the microbatch dim over dp under a mapping (the reference's
    reshape and constraint), then one view a microbatch."""
    stacked = constrain_batch_tree(tree_map(
        lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                            + tuple(x.shape[1:])), batch), leading=1)
    return [tree_map(lambda x: x[i], stacked) for i in range(n_micro)]


def train_step_fn(cfg: ModelConfig, optim_cfg: AdamWConfig | None = None):
    """`train_step(params, opt_state, batch) -> (params, opt_state,
    stats)`: the global batch split into microbatches of
    min(cfg.microbatch, batch), their gradients accumulated, then one
    optimizer update, in place. `cfg.grad_accum`:
      "scan_of_grads" — one backward a microbatch, each gradient added
        into an accumulator of `cfg.grad_accum_dtype` (f32 by default),
        which is then divided by the microbatch count;
      "grad_of_scan"  — one backward through the mean of the microbatch
        losses, each microbatch's forward rematerialized whole.
    `stats["loss"]` is the mean of the microbatch losses. The params'
    leaves are made to require grad. With `cfg.use_pallas_attn` the
    forward refuses to differentiate through the flash kernel, which has
    no backward (`kernels.build.check_no_grad`)."""
    _, update = make_optimizer(cfg, optim_cfg)
    acc_dtype = (torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16"
                 else torch.float32)

    def grads_of(loss, leaves):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        gb = tree_leaves(batch)[0].shape[0]
        mb = min(cfg.microbatch, gb)
        if gb % mb:
            raise ValueError(f"global batch {gb} does not split into "
                             f"microbatches of {mb}")
        n_micro = gb // mb
        micro = split_microbatches(batch, n_micro)
        dev = leaves[0].device
        if cfg.grad_accum == "grad_of_scan":
            s = torch.zeros((), dtype=torch.float32, device=dev)
            for mbatch in micro:
                s = s + checkpoint(lambda m: loss_fn(params, cfg, m),
                                   mbatch, use_reentrant=False)
            loss_mean = divide(s, n_micro)
            grads = grads_of(loss_mean, leaves)
            loss_sum = loss_mean.detach() * n_micro
        else:
            grads = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for mbatch in micro:
                loss = loss_fn(params, cfg, mbatch)
                with torch.no_grad():
                    for acc, g in zip(grads, grads_of(loss, leaves)):
                        acc.add_(g.to(acc_dtype))
                loss_sum = loss_sum + loss.detach()
            for acc in grads:
                acc.div_(torch.full((), n_micro, dtype=acc.dtype,
                                    device=acc.device))
        with torch.no_grad():
            params, opt_state, stats = update(
                params, tree_unflatten(params, grads), opt_state)
        stats["loss"] = divide(loss_sum, n_micro)
        return params, opt_state, stats

    return train_step


# ----------------------------------------------------------------------------
# Serving: prefill + decode
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device="cuda") -> list:
    dev = resolve_device(device)
    return [tuple(block_cache_init(cfg, elem, batch, capacity,
                                   (stack.repeats,), dev)
                  for elem in stack.pattern)
            for stack in cfg.stacks]


def cache_abstract(cfg: ModelConfig, batch: int, capacity: int) -> list:
    """`init_cache`'s tree on the meta device (shapes and dtypes)."""
    return init_cache(cfg, batch, capacity, device="meta")


def prefill_step_fn(cfg: ModelConfig, capacity: int):
    """`prefill(params, batch) -> (logits of the last position, caches)`,
    recorded as the root span `lm.prefill` while `tracing` records."""
    def prefill(params, batch):
        with tracing.span("lm.prefill") as s:
            if s is not None:
                s.attrs.update(_prefill_attrs(cfg, batch))
            return _prefill(params, batch)

    def _prefill(params, batch):
        with _io_span("embed", cfg):
            x = _embed_inputs(params, cfg, batch)
        xsrc = _cross_source(params, cfg, batch["text"]) \
            if cfg.cross_attn_dim else None
        caches = []
        for stack, elem_params in zip(cfg.stacks, params["stacks"]):
            per_layer = []
            for i in range(stack.repeats):
                layer_caches = []
                for elem, p in zip(stack.pattern, elem_params):
                    with tracing.span("block"):
                        x, c = block_apply_prefill(_index(p, i), cfg, elem,
                                                   x, capacity, xsrc)
                    layer_caches.append(c)
                per_layer.append(layer_caches)
            caches.append(tuple(_stack([lc[e] for lc in per_layer])
                                for e in range(len(stack.pattern))))
        with _io_span("logits", cfg):
            h = L.norm(params["final_norm"], cfg, x)
            logits = logits_fn(params, cfg, h[:, -1:, :])
        return logits, caches

    return prefill


def _io_span(name: str, cfg: ModelConfig):
    """The span `embed` or `logits`, with the attribute `codebooks` where
    the config has them."""
    s = tracing.span(name)
    if cfg.num_codebooks and tracing.recording():
        s.attrs["codebooks"] = cfg.num_codebooks
    return s


def _prefill_attrs(cfg: ModelConfig, batch: dict) -> dict:
    """`lm.prefill`'s attributes: the batch and the sequence length."""
    if cfg.num_codebooks:
        return {"batch": batch["codes"].shape[0],
                "seq": batch["codes"].shape[-1]}
    x = batch["embeddings"] if cfg.embed_inputs else batch["tokens"]
    return {"batch": x.shape[0],
            "seq": x.shape[1] + (cfg.num_patch_tokens or 0)}


def decode_step_fn(cfg: ModelConfig):
    def decode(params, caches, tokens, pos):
        """tokens: [B,1] int, or codes [B,K,1] with K codebooks; pos: int,
        the tokens' position. Every arch embeds tokens here, the
        front-end ones too. Updates `caches` in place (a cross cache is
        only read); returns (logits [B,1,V] or [B,1,K,V], caches)."""
        pos = int(pos)
        with tracing.span("lm.decode") as s:
            if s is not None:
                s.attrs.update(batch=tokens.shape[0], pos=pos)
            with _io_span("embed", cfg):
                x = _embed_tokens(params, cfg, tokens, pos)
            for stack, elem_params, stack_cache in zip(
                    cfg.stacks, params["stacks"], caches):
                for i in range(stack.repeats):
                    for elem, p, c in zip(stack.pattern, elem_params,
                                          stack_cache):
                        with tracing.span("block"):
                            x, _ = block_apply_decode(_index(p, i), cfg,
                                                      elem, x, _index(c, i),
                                                      pos)
            with _io_span("logits", cfg):
                h = L.norm(params["final_norm"], cfg, x)
                logits = logits_fn(params, cfg, h)
        return logits, caches

    return decode


def delay_codes(codes: torch.Tensor, pos: int, frames: int,
                pad: int) -> torch.Tensor:
    """MusicGen's delay pattern on the codes [B,K] picked for position
    `pos` of a delayed sequence (position 0 the start, all `pad`):
    codebook k runs k positions behind codebook 0, so it gives `pad`
    until its first frame (pos <= k) and again after its last of
    `frames` (pos > frames + k). A clip of n frames fills positions 1 to
    n + K - 1. On the device, with no host sync."""
    k = torch.arange(codes.shape[1], device=codes.device)
    free = (k < pos) & (pos <= frames + k)
    return torch.where(free, codes, pad)


def param_count(params) -> int:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
        else:
            yield t
    return int(sum(x.numel() for x in leaves(params)))


def analytic_param_count(cfg: ModelConfig) -> int:
    """The parameter count from the abstract tree, with no allocation."""
    return param_count(init_abstract(cfg))
