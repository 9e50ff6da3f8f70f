"""Plain float32 reference of a Mamba-2 language model as the port runs it,
for the test that finds a configuration of a kind with no cell yet by
its name: the test copies this file into a temporary benchmark's
`reference/`, beside `_plain.py`.

Attention-free: every layer is x + mixer(rmsnorm(x)), with no MLP; the
output head is the embedding, tied. The mixer (Mamba-2's SSD): one
in-projection to (z, x, B, C, dt); a causal depthwise convolution over
(x, B, C), then its silu; dt = softplus(dt + dt_bias) a head; the
recurrence h_t = exp(dt_t·a)·h_{t-1} + B_t ⊗ (dt_t·x_t) with
a = -exp(A_log), read out as y_t = C_t·h_t + D·x_t, one token after the
other; then rmsnorm(y·silu(z)) and the out-projection. The cache is the
final state and the convolution's last `d_conv - 1` inputs.
"""
from __future__ import annotations

import importlib.util
import os

import torch
import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_plain",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_plain.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)


def _dims(cfg: dict):
    d_inner = cfg["expand"] * cfg["d_model"]
    return d_inner, d_inner // cfg["headdim"], cfg["headdim"], \
        cfg["d_state"]


def shapes(cfg: dict) -> dict:
    """The model's shapes for the yardstick: the mixer as counts."""
    D = cfg["d_model"]
    d_inner, H, hp, N = _dims(cfg)
    conv = d_inner + 2 * cfg["ngroups"] * N
    w = D * (2 * d_inner + 2 * cfg["ngroups"] * N + H) + d_inner * D
    mixer = {"kind": "counts", "weights": w, "token_weights": w,
             "token_flops": 4 * H * N * hp + 2 * cfg["d_conv"] * conv,
             "state_bytes": 4 * H * N * hp + 2 * (cfg["d_conv"] - 1) * conv}
    return {"d_model": D, "vocab": cfg["vocab_size"], "tied": True,
            "layers": [{"mixer": mixer}] * cfg["n_layer"]}


def _ssd(p: dict, cfg: dict, h: torch.Tensor, prec: str):
    B, S, _ = h.shape
    d_inner, H, hp, N = _dims(cfg)
    W = cfg["d_conv"]
    z, xs, Bm, Cm, dt = torch.split(
        P.mm(h, P.weight(p["w_in"], prec), prec),
        [d_inner, d_inner, N, N, H], dim=-1)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[:, i:i + S] * p["conv_w"][i].float() for i in range(W))
    xs, Bm, Cm = torch.split(F.silu(conv + p["conv_b"].float()),
                             [d_inner, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())                 # [B,S,H]
    a = -torch.exp(p["A_log"].float())
    X = xs.reshape(B, S, H, hp)
    state = torch.zeros((B, H, N, hp), dtype=torch.float32, device=h.device)
    ys = []
    for t in range(S):
        state = (state * torch.exp(dt[:, t] * a)[:, :, None, None]
                 + Bm[:, t, None, :, None]
                 * (X[:, t] * dt[:, t, :, None])[:, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], state))
    y = torch.stack(ys, 1) + p["D_skip"].float()[None, None, :, None] * X
    y = P.rmsnorm(y.reshape(B, S, d_inner) * F.silu(z),
                  p["y_norm"]["scale"], cfg["norm_epsilon"])
    return P.mm(y, P.weight(p["w_out"], prec), prec), \
        {"state": state, "conv": xbc[:, S - (W - 1):]}


def forward(params: dict, cfg: dict, tokens: torch.Tensor,
            groups: list[torch.Tensor], rows: torch.Tensor,
            prec: str = "f32"):
    """tokens [B, S] -> (logits [len(rows), V] float32 at the flattened
    positions `rows`, the caches: one {"state" [B, H, N, P], "conv"
    [B, d_conv - 1, channels]} per layer). No MoE: `groups` is unused."""
    del groups
    cfg = P.as_run(cfg)
    with P.no_tf32():
        x = params["embed"][tokens.long()].float() \
            * cfg["embedding_multiplier"]
        caches = []
        for layer in P.layers(params):
            h = P.rmsnorm(x, layer["norm1"]["scale"], cfg["norm_epsilon"])
            y, cache = _ssd(layer["mixer"], cfg, h, prec)
            caches.append(cache)
            x = x + y
        h = P.rmsnorm(x, params["final_norm"]["scale"], cfg["norm_epsilon"])
        return P.logits_at(h, rows, params["embed"].T, prec), caches
