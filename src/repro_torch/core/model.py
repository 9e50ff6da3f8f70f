"""The learned performance model (paper §3), in PyTorch.

Counterpart of `repro.core.model`. Pipeline:
  opcode embedding ⊕ node scalar features [⊕ kernel features (option 1)]
    → f1 → GraphSAGE
    → node-final MLP (3 layers, Table 5)
    → reduction (per-node | column-wise | Transformer)
      [⊕ kernel features (option 2)]
    → linear head (no activation) → scalar prediction per kernel.

`CostModel` is an `nn.Module` whose `state_dict` keys mirror the JAX
parameter tree's paths (`opcode_embed.table`, `gnn.layers.0.f2_in.w`,
`gnn.stacked.f3.w`, ...); `cost_model_apply` is a plain function on the
nested parameter dict `CostModel.tree()` returns. Inference only: the
forward runs under `torch.inference_mode()` in `core.evaluate`, and
dropout is the identity. Not ported yet (raise `NotImplementedError`):
GAT, the LSTM reduction, `precision="int8"` and `SegmentedGraphBatch`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, asdict

import numpy as np
import torch
from torch import nn

from repro_torch.core import features as F
from repro_torch.core import gnn as G
from repro_torch.core import reductions as R
from repro_torch.core.device import resolve_device
from repro_torch.core.opset import NUM_OPCODES
from repro_torch.nn.core import (
    dense_apply,
    dense_init,
    embedding_apply,
    embedding_init,
    mlp_apply,
    mlp_init,
)


@dataclass
class CostModelConfig:
    gnn: str = "graphsage"               # graphsage | gat | none
    reduction: str = "transformer"       # per_node | column_wise | lstm | transformer
    hidden_dim: int = 192
    opcode_embed_dim: int = 64           # paper uses 256
    gnn_layers: int = 3                  # Table 5
    node_final_layers: int = 3           # Table 5
    aggregator: str = "mean"             # Table 5
    directed: bool = True                # 'vanilla'; False = ablation
    kernel_feat_mode: str = "node"       # 'node' (option 1) | 'kernel' (option 2)
    include_static_perf: bool = True
    include_tile: bool = True
    transformer_layers: int = 1
    transformer_heads: int = 4
    gat_heads: int = 2
    dropout: float = 0.1
    max_nodes: int = 64
    # hand-written aggregation kernels: kernels/graph_aggregate on the
    # dense layout, kernels/segment_aggregate on the sparse one
    use_pallas_aggregate: bool = False
    adjacency: str = "dense"             # dense | sparse | segmented
    # GNN parameters stored stacked ([L, ...] leaves) instead of unrolled
    scan_layers: bool = False
    precision: str = "f32"               # f32 | int8

    def __post_init__(self):
        if self.adjacency not in ("dense", "sparse", "segmented"):
            raise ValueError(f"unknown adjacency {self.adjacency!r} "
                             "(dense | sparse | segmented)")
        if self.precision not in ("f32", "int8"):
            raise ValueError(f"unknown precision {self.precision!r} "
                             "(f32 | int8)")
        if self.use_pallas_aggregate and self.gnn != "graphsage":
            raise ValueError(
                f"use_pallas_aggregate supports gnn='graphsage' only, got "
                f"gnn={self.gnn!r} (dense layout: kernels/graph_aggregate; "
                "sparse/segmented: kernels/segment_aggregate)")

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CostModelConfig":
        return CostModelConfig(**d)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


# ----------------------------------------------------------------------------
# Parameters: nested dict tree <-> nn.Module
# ----------------------------------------------------------------------------
def _fill(mod: nn.Module, tree: dict) -> nn.Module:
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
        elif isinstance(v, (list, tuple)):
            mod.add_module(k, nn.ModuleList([_fill(nn.Module(), t)
                                             for t in v]))
        else:
            mod.add_module(k, _fill(nn.Module(), v))
    return mod


def _module_to_tree(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return [_module_to_tree(m) for m in mod]
    tree = {k: p for k, p in mod.named_parameters(recurse=False)}
    tree.update({k: _module_to_tree(m) for k, m in mod.named_children()})
    return tree


class CostModel(nn.Module):
    """Parameters of one cost model. `tree()` gives the nested dict that
    `cost_model_apply` takes."""

    def __init__(self, params: dict, cfg: CostModelConfig):
        super().__init__()
        self.cfg = cfg
        _fill(self, params)

    def tree(self) -> dict:
        return _module_to_tree(self)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def cost_model_init(gen: torch.Generator, cfg: CostModelConfig, *,
                    device: str | torch.device = "cuda",
                    dtype=torch.float32) -> CostModel:
    """Random parameters drawn from `gen` (a CPU generator), placed on
    `device`. Raises if `device` is a CUDA device and none is present."""
    dev = resolve_device(device)
    if cfg.gnn == "gat":
        raise _not_ported("gnn='gat'")
    if cfg.gnn not in ("graphsage", "none"):
        raise ValueError(f"unknown gnn {cfg.gnn!r}")
    d = cfg.hidden_dim
    in_dim = cfg.opcode_embed_dim + F.NODE_FEATURE_DIM
    if cfg.kernel_feat_mode == "node":
        in_dim += F.KERNEL_FEATURE_DIM
    params = {
        "opcode_embed": embedding_init(gen, NUM_OPCODES,
                                       cfg.opcode_embed_dim, dtype=dtype),
        "f1": dense_init(gen, in_dim, d, bias=False, dtype=dtype),
        "node_final": mlp_init(gen, [d] * (cfg.node_final_layers + 1),
                               bias=False, dtype=dtype),
        "reduction": R.reduction_init(
            gen, cfg.reduction, d, transformer_layers=cfg.transformer_layers,
            transformer_heads=cfg.transformer_heads, dtype=dtype),
    }
    if cfg.gnn == "graphsage":
        params["gnn"] = G.sage_init(gen, d, cfg.gnn_layers,
                                    directed=cfg.directed, dtype=dtype)
        if cfg.scan_layers and params["gnn"]["layers"]:
            params["gnn"] = G.stack_params(params["gnn"])
    if cfg.reduction == "per_node":
        params["node_head"] = dense_init(gen, d, 1, bias=False, dtype=dtype)
        if cfg.kernel_feat_mode == "kernel":
            params["kernel_head"] = dense_init(
                gen, F.KERNEL_FEATURE_DIM, 1, bias=False, dtype=dtype)
    else:
        out_dim = R.reduction_out_dim(cfg.reduction, d)
        if cfg.kernel_feat_mode == "kernel":
            out_dim += F.KERNEL_FEATURE_DIM
        params["head"] = dense_init(gen, out_dim, 1, bias=False, dtype=dtype)
    return CostModel(params, cfg).to(dev)


# ----------------------------------------------------------------------------
# Batches
# ----------------------------------------------------------------------------
def batch_to_device(batch, device: torch.device):
    """A `GraphBatch`/`SparseGraphBatch` of numpy arrays → the same
    dataclass holding tensors on `device` (one copy per array)."""
    if isinstance(batch, F.SegmentedGraphBatch):
        raise _not_ported("the segmented layout (SegmentedGraphBatch)")
    return dataclasses.replace(batch, **{
        f.name: torch.from_numpy(np.ascontiguousarray(
            getattr(batch, f.name))).to(device)
        for f in dataclasses.fields(batch)})


def _mask_kernel_feats(cfg: CostModelConfig,
                       kfeats: torch.Tensor) -> torch.Tensor:
    if cfg.include_tile and cfg.include_static_perf:
        return kfeats
    kfeats = kfeats.clone()
    if not cfg.include_tile:
        kfeats[:, F.TILE_SLICE] = 0.0
    if not cfg.include_static_perf:
        kfeats[:, F.STATIC_PERF_SLICE] = 0.0
    return kfeats


def _check_supported(cfg: CostModelConfig, batch) -> None:
    if cfg.precision == "int8":
        raise _not_ported("precision='int8'")
    if cfg.gnn == "gat":
        raise _not_ported("gnn='gat'")
    if isinstance(batch, F.SegmentedGraphBatch):
        raise _not_ported("the segmented layout (SegmentedGraphBatch)")


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------
def cost_model_apply(params: dict, cfg: CostModelConfig,
                     batch) -> torch.Tensor:
    """batch: `GraphBatch` or `SparseGraphBatch` holding tensors (see
    `batch_to_device`). Returns predictions [B] (one per graph slot)."""
    _check_supported(cfg, batch)
    if isinstance(batch, F.SparseGraphBatch):
        eps = _embed_sparse(params, cfg, batch)
        return _readout_sparse(params, cfg, eps, batch.node_mask,
                               batch.graph_ids, batch.kernel_feats,
                               batch.gather_idx, batch.gather_mask)
    opcodes = batch.opcodes
    adj = batch.adj
    mask = batch.node_mask
    kfeats = _mask_kernel_feats(cfg, batch.kernel_feats)

    emb = embedding_apply(params["opcode_embed"], opcodes)      # [B,N,E]
    x = torch.cat([emb, batch.node_feats], dim=-1)
    if cfg.kernel_feat_mode == "node":
        B, N = opcodes.shape
        kf = kfeats[:, None, :].expand(B, N, kfeats.shape[-1])
        x = torch.cat([x, kf], dim=-1)

    eps = torch.relu(dense_apply(params["f1"], x)) * mask[..., None]
    if cfg.gnn == "graphsage":
        eps = G.sage_apply(params["gnn"], eps, adj, mask,
                           aggregator=cfg.aggregator, directed=cfg.directed,
                           use_kernel=cfg.use_pallas_aggregate)

    eps = mlp_apply(params["node_final"], eps, final_act=True)
    eps = eps * mask[..., None]

    if cfg.reduction == "per_node":
        per_node = dense_apply(params["node_head"], eps)[..., 0]  # [B,N]
        y = torch.sum(per_node * mask, dim=1)
        if cfg.kernel_feat_mode == "kernel":
            y = y + dense_apply(params["kernel_head"], kfeats)[..., 0]
        return y

    kappa = R.reduction_apply(params["reduction"], cfg.reduction, eps, mask,
                              transformer_heads=cfg.transformer_heads)
    if cfg.kernel_feat_mode == "kernel":
        kappa = torch.cat([kappa, kfeats], dim=-1)
    return dense_apply(params["head"], kappa)[..., 0]


def _embed_sparse(params: dict, cfg: CostModelConfig,
                  batch) -> torch.Tensor:
    """Embed + f1 + GNN over a flat sparse node buffer."""
    mask = batch.node_mask                       # [M]
    kfeats = _mask_kernel_feats(cfg, batch.kernel_feats)

    emb = embedding_apply(params["opcode_embed"], batch.opcodes)  # [M, E]
    x = torch.cat([emb, batch.node_feats], dim=-1)
    if cfg.kernel_feat_mode == "node":
        x = torch.cat([x, kfeats[batch.graph_ids.long()]], dim=-1)

    eps = torch.relu(dense_apply(params["f1"], x)) * mask[:, None]
    if cfg.gnn == "graphsage":
        eps = G.sage_apply_sparse(params["gnn"], eps, batch.edge_src,
                                  batch.edge_dst, batch.edge_mask, mask,
                                  aggregator=cfg.aggregator,
                                  directed=cfg.directed,
                                  use_kernel=cfg.use_pallas_aggregate)
    return eps


def _readout_sparse(params: dict, cfg: CostModelConfig, eps: torch.Tensor,
                    mask: torch.Tensor, gids: torch.Tensor,
                    kfeats: torch.Tensor, gather_idx: torch.Tensor,
                    gather_mask: torch.Tensor) -> torch.Tensor:
    """node-final MLP + reduction + head over a flat [M, D] embedding
    buffer with per-node graph ids."""
    num_graphs = kfeats.shape[0]
    kfeats = _mask_kernel_feats(cfg, kfeats)
    gids = gids.long()

    eps = mlp_apply(params["node_final"], eps, final_act=True)
    eps = eps * mask[:, None]

    if cfg.reduction == "per_node":
        per_node = dense_apply(params["node_head"], eps)[..., 0]   # [M]
        y = torch.zeros((num_graphs,), dtype=eps.dtype, device=eps.device)
        y.index_add_(0, gids, per_node * mask)
        if cfg.kernel_feat_mode == "kernel":
            y = y + dense_apply(params["kernel_head"], kfeats)[..., 0]
        return y

    if cfg.reduction == "column_wise":
        D = eps.shape[-1]
        s = torch.zeros((num_graphs, D), dtype=eps.dtype, device=eps.device)
        s.index_add_(0, gids, eps * mask[:, None])
        cnt = torch.zeros((num_graphs,), dtype=eps.dtype,
                          device=eps.device).index_add_(0, gids, mask)
        n = torch.clamp(cnt, min=1.0)
        neg = torch.finfo(eps.dtype).min
        vals = torch.where(mask[:, None] > 0, eps, torch.full_like(eps, neg))
        mx = torch.full((num_graphs, D), neg, dtype=eps.dtype,
                        device=eps.device)
        mx.scatter_reduce_(0, gids[:, None].expand(-1, D), vals,
                           reduce="amax", include_self=True)
        # padding graph slots have no nodes; zero them instead of the
        # dtype minimum so the head stays finite
        mx = torch.where(cnt[:, None] > 0, mx, torch.zeros_like(mx))
        kappa = torch.cat([s / n[:, None], mx], dim=-1)
    else:
        # sequence reductions need per-graph node order: gather the flat
        # buffer into [G, R, D] (sentinel index M → an appended zero row)
        eps_pad = torch.cat([eps, eps.new_zeros((1, eps.shape[-1]))], dim=0)
        seq = eps_pad[gather_idx.long()]                           # [G,R,D]
        kappa = R.reduction_apply(params["reduction"], cfg.reduction, seq,
                                  gather_mask,
                                  transformer_heads=cfg.transformer_heads)
    if cfg.kernel_feat_mode == "kernel":
        kappa = torch.cat([kappa, kfeats], dim=-1)
    return dense_apply(params["head"], kappa)[..., 0]
