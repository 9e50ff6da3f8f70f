"""Roofline analysis from dry-run artifacts: `repro.roofline.analysis`
for the port's records (`repro_torch.launch.lowering`), with the H100's
constants (`H100_HW`) beside the reference's TPU v5e ones (`ROOFLINE_HW`).
`roofline_terms`, `build_table` and `render_markdown` take either as
`hw`.

Per (arch × shape × mesh) cell, per device:

  compute term    = HLO_FLOPs_per_device / peak_FLOP/s
                  ( = total FLOPs / (chips × peak) — cost_analysis() is
                    per-device under SPMD, verified empirically )
  memory term     = HLO_bytes_per_device / HBM_bw
                  ('bytes accessed' counts operand+output bytes per op —
                   an upper bound on HBM traffic since VMEM reuse is not
                   visible at HLO level; stated with the table)
  collective term = collective_bytes_per_device / link_bw
                  (sum of collective op output bytes in per-device HLO;
                   ring-style (n-1)/n wire factors are ignored — ≤7% at 16)

plus MODEL_FLOPS = 6·N·tokens (train) / 2·N·tokens (inference), N = active
params for MoE, and the ratio MODEL_FLOPS / HLO_FLOPs (total) — the
"useful-compute" fraction that catches remat/redundancy waste.

Hardware constants: `ROOFLINE_HW` is the reference's TPU v5e-class chip
(197 TF/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI), kept so that records
price as the reference prices them; `H100_HW` is one H100 SXM5 card of a
node of eight.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

ROOFLINE_HW = {
    "peak_flops": 197e12,      # bf16 per chip
    "hbm_bw": 819e9,           # bytes/s per chip
    "ici_bw": 50e9,            # bytes/s per link
    "hbm_bytes": 16 * 1024**3, # v5e HBM capacity per chip
}

# One H100 SXM5 80GB card. The production meshes (16x16, 2x16x16) stand
# for 256 or 512 cards, 32 or 64 nodes of 8: a 16-wide mesh axis crosses
# a node, so every collective of the dry-run has a leg on the network and
# the collective term divides by `link_bw`, one card's network rate.
# `nvlink_bw` (within a node) is kept for comparison and used by no term.
H100_HW = {
    "peak_flops": 989e12,      # bf16 dense, H100 SXM5 datasheet
    "hbm_bw": 3.35e12,         # bytes/s, H100 SXM5 datasheet (HBM3)
    "link_bw": 50e9,           # bytes/s: one 400 Gb/s NDR InfiniBand NIC
    #                            per card, as in a DGX H100
    "nvlink_bw": 450e9,        # bytes/s per direction: NVLink 4, 900 GB/s
    #                            bidirectional (datasheet)
    "hbm_bytes": 80e9,         # "80GB"
}


def link_bw(hw: dict) -> float:
    """The rate the collective term divides by: `link_bw` where the table
    has one (H100_HW), else the reference's per-link `ici_bw`."""
    return hw["link_bw"] if "link_bw" in hw else hw["ici_bw"]

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")


def analytic_memory_bytes(cfg, shape, total_params: int, *, dp: int = 16,
                          tp: int = 16) -> float:
    """Fused-execution HBM-traffic estimate per device (bytes per step).

    HLO 'bytes accessed' counts every op's operands — an UNFUSED upper
    bound (flash-attention scores, MoE dispatch buffers etc. stay in VMEM
    on TPU). This estimate models what actually crosses HBM on a fused TPU
    execution: weight streaming per microbatch (×3 with remat: fwd, re-fwd,
    bwd), optimizer state traffic, gradient-accumulator read-modify-write,
    layer-boundary activations, logits, and KV-cache traffic for serving.
    """
    devices = dp * tp
    params_dev = total_params / devices
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    if shape.kind == "train":
        mb = min(cfg.microbatch, shape.global_batch)
        n_micro = max(shape.global_batch // mb, 1)
        b_dev = max(mb / dp, 1)
        S = shape.seq_len
        weight_passes = 3 if cfg.remat != "none" else 2
        weights = params_dev * 2 * n_micro * weight_passes
        opt = params_dev * (6 if cfg.optimizer == "adafactor" else 20)
        grad_accum = params_dev * 4 * 2 * n_micro
        k_act = 6 if cfg.remat != "none" else 4
        acts = n_micro * L * b_dev * S * D * 2 * k_act
        logits = n_micro * b_dev * S * (V / tp) * 2 * 3
        return weights + opt + grad_accum + acts + logits
    if shape.kind == "prefill":
        b_dev = max(shape.global_batch / dp, 1)
        S = shape.seq_len
        weights = params_dev * 2
        acts = L * b_dev * S * D * 2 * 3
        cache = L * b_dev * S * D * 2       # rough cache-write proxy
        return weights + acts + cache
    # decode: weights + full cache read per token
    b_dev = max(shape.global_batch / dp, 1)
    cache_read = 0.0
    for t in cfg.layer_types():
        mixer = t.split("+")[0]
        if mixer == "attn":
            cache_read += (b_dev * shape.seq_len *
                           cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2
                           / tp)
        elif mixer == "swa":
            w = min(cfg.sliding_window, shape.seq_len)
            cache_read += (b_dev * w * cfg.num_kv_heads *
                           cfg.resolved_head_dim * 2 * 2 / tp)
        elif mixer == "mla":
            cache_read += (b_dev * shape.seq_len *
                           (cfg.mla.kv_lora_rank +
                            cfg.mla.qk_rope_head_dim) * 2 / tp)
        elif mixer == "ssd":
            d_inner = cfg.ssm.expand * cfg.d_model
            H = d_inner // cfg.ssm.head_dim
            cache_read += b_dev * H / tp * cfg.ssm.d_state * \
                cfg.ssm.head_dim * 4 * 2
        elif mixer == "rglru":
            W = cfg.rglru.lru_width or cfg.d_model
            cache_read += b_dev * W / tp * 4 * 2
    if cfg.moe is not None:
        # decode streams only routed experts' weights
        mc = cfg.moe
        moe_layers = sum(1 for t in cfg.layer_types() if t.endswith("+moe"))
        all_exp = moe_layers * mc.num_experts * 3 * D * mc.d_ff_expert
        act_exp = moe_layers * min(
            mc.top_k * shape.global_batch, mc.num_experts) * 3 * D * \
            mc.d_ff_expert
        params_active_dev = (total_params - all_exp + act_exp) / devices
        weights = params_active_dev * 2
    else:
        weights = params_dev * 2
    return weights + cache_read


# ----------------------------------------------------------------------------
# MODEL_FLOPS
# ----------------------------------------------------------------------------
def _expert_params(cfg) -> tuple[int, int]:
    """(total expert params, active expert params) across all layers."""
    if cfg.moe is None:
        return 0, 0
    mc = cfg.moe
    moe_layers = sum(1 for t in cfg.layer_types() if t.endswith("+moe"))
    per_expert = 3 * cfg.d_model * mc.d_ff_expert
    total = moe_layers * mc.num_experts * per_expert
    active = moe_layers * mc.top_k * per_expert
    return total, active


def active_param_count(cfg, total_params: int) -> int:
    total_exp, active_exp = _expert_params(cfg)
    return int(total_params - total_exp + active_exp)


def model_flops(cfg, shape, total_params: int) -> float:
    """6·N·D for training, 2·N·D for inference forward (N = active params,
    D = tokens processed)."""
    n_active = active_param_count(cfg, total_params)
    # embedding gather does no matmul flops; subtract the embed table
    n_active -= cfg.vocab_size * cfg.d_model
    if shape.kind == "decode":
        tokens = shape.global_batch * 1
        mult = 2.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    # unembedding matmul is real compute: add 2·d·V per token (×3 for bwd)
    lm_head = 2.0 * cfg.d_model * cfg.vocab_size * tokens
    if shape.kind == "train":
        lm_head *= 3.0
    return mult * n_active * tokens + lm_head


# ----------------------------------------------------------------------------
# Per-cell terms
# ----------------------------------------------------------------------------
@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    hlo_flops_total: float
    model_flops: float
    useful_ratio: float
    peak_mem_gb: float
    fits_hbm: bool
    note: str = ""
    memory_upper_s: float = 0.0    # unfused HLO-bytes upper bound

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms) — 1.0 means perfectly
        compute-bound (the best an optimizer can do is reach the compute
        roofline)."""
        return self.compute_s / max(self.bound_time, 1e-30)


def roofline_terms(rec: dict, cfg, shape, hw=ROOFLINE_HW) -> RooflineRow:
    devices = rec.get("devices", 1)
    cost = rec.get("cost", {})
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll = rec.get("collectives", {})
    coll_dev = float(sum(v for k, v in coll.items() if k in _COLL_OPS))

    compute_s = flops_dev / hw["peak_flops"]
    memory_s = bytes_dev / hw["hbm_bw"]
    collective_s = coll_dev / link_bw(hw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    total_params = rec.get("params_bytes", 0) // 2   # bf16
    mf = model_flops(cfg, shape, total_params)
    hlo_total = flops_dev * devices
    ratio = mf / hlo_total if hlo_total > 0 else float("nan")

    peak = rec.get("memory", {}).get("peak_memory_in_bytes", 0)
    if not peak:
        m = rec.get("memory", {})
        peak = (m.get("argument_size_in_bytes", 0) +
                m.get("temp_size_in_bytes", 0) +
                m.get("output_size_in_bytes", 0) -
                m.get("alias_size_in_bytes", 0))
    note = _suggestion(dominant, ratio, shape)
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        devices=devices, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        hlo_flops_total=hlo_total, model_flops=mf, useful_ratio=ratio,
        peak_mem_gb=peak / 1024**3, fits_hbm=peak <= hw["hbm_bytes"],
        note=note)


def _suggestion(dominant: str, ratio: float, shape) -> str:
    if dominant == "compute":
        if ratio < 0.5:
            return ("compute-bound but <50% useful FLOPs — reduce remat "
                    "recompute / dead padding work")
        return "compute-bound — already at the right wall; fuse or lower precision"
    if dominant == "memory":
        if shape.kind == "decode":
            return ("memory-bound (weight/cache streaming) — batch more "
                    "decode requests per step or quantize weights/cache")
        return ("memory-bound — increase arithmetic intensity: larger "
                "microbatch, fused matmuls, fewer materialized intermediates")
    return ("collective-bound — reshard to cut gathered bytes (FSDP→TP "
            "ratio), overlap collectives with compute, or compress")


# ----------------------------------------------------------------------------
# Table over all dry-run records
# ----------------------------------------------------------------------------
def build_table(dryrun_dir: str, hw=ROOFLINE_HW) -> list[RooflineRow]:
    from repro_torch.models import SHAPES, registry
    rows = []
    for fname in sorted(os.listdir(dryrun_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(dryrun_dir, fname)) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        cfg = registry.get_config(rec["arch"])
        shape = SHAPES[rec["shape"]]
        rows.append(roofline_terms(rec, cfg, shape, hw))
    return rows


def capacity_label(hw: dict) -> str:
    """`hw`'s memory a device as the header names it: "16 GiB" for the
    v5e, "80 GB" for the H100."""
    n = hw["hbm_bytes"]
    if n % 1024**3 == 0:
        return f"{n // 1024**3} GiB"
    return f"{n / 1e9:g} GB"


def render_markdown(rows: list[RooflineRow], hw=ROOFLINE_HW) -> str:
    """The table's "fits" column was checked against `hw`'s memory (the
    reference's header says 16G whatever the rows were priced with)."""
    out = ["| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
           f"| bound | useful FLOPs | peak mem/dev | fits "
           f"{capacity_label(hw)} |",
           "|---|---|---|---|---|---|---|---|---|---|"[:-4]]
    for r in sorted(rows, key=lambda r: (r.mesh, r.arch, r.shape)):
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | **{r.dominant}** | "
            f"{100*r.useful_ratio:.0f}% | {r.peak_mem_gb:.2f} GiB | "
            f"{'yes' if r.fits_hbm else 'NO'} |")
    return "\n".join(out)
