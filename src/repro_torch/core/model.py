"""The learned performance model (paper §3), in PyTorch.

Counterpart of `repro.core.model`. Pipeline:
  opcode embedding ⊕ node scalar features [⊕ kernel features (option 1)]
    → f1 → GraphSAGE | GAT
    → node-final MLP (3 layers, Table 5)
    → reduction (per-node | column-wise | LSTM | Transformer)
      [⊕ kernel features (option 2)]
    → linear head (no activation) → scalar prediction per kernel.

`CostModel` is an `nn.Module` whose `state_dict` keys mirror the JAX
parameter tree's paths (`opcode_embed.table`, `gnn.layers.0.f2_in.w`,
`gnn.stacked.f3.w`, ...); `cost_model_apply` is a plain function on the
nested parameter dict `CostModel.tree()` returns. Its f32 leaves are
`nn.Parameter`s that do not require grad: inference (under
`torch.inference_mode()` in `core.evaluate`) sees them so, and the
trainer (`training.trainer`) makes them trainable with the module's own
`requires_grad_()`. Dropout runs only with `training=True` and a
generator; by default the forward is the inference path.

Batches: `GraphBatch` (dense), `SparseGraphBatch` (packed) and
`SegmentedGraphBatch` (whole programs cut into blocks, reassembled
before the readout). Under ``precision="int8"`` the tree holds
`quant.scale.QuantizedLeaf`s (a `CostModel` keeps their `q` and `scale`
as buffers, keys `….w.q` / `….w.scale`); they are dequantized per
forward, except that the GNN's f2 weights stay int8 into the
`segment_aggregate` kernel on the sparse and segmented layouts with the
kernels on.
"""
from __future__ import annotations

import dataclasses
import itertools
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
    dropout,
    embedding_apply,
    embedding_init,
    mlp_apply,
    mlp_init,
)
from repro_torch.quant.scale import QuantizedLeaf, dequantize_tree


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


# ----------------------------------------------------------------------------
# Parameters: nested dict tree <-> nn.Module
# ----------------------------------------------------------------------------
class _QuantizedLeafModule(nn.Module):
    """One `QuantizedLeaf` inside a `CostModel`: int8 `q` and f32 `scale`
    as buffers (not parameters: int8 cannot require grad)."""

    def __init__(self, leaf: QuantizedLeaf):
        super().__init__()
        self.register_buffer("q", leaf.q)
        self.register_buffer("scale", leaf.scale)


def _fill(mod: nn.Module, tree: dict) -> nn.Module:
    for k, v in tree.items():
        if isinstance(v, QuantizedLeaf):
            mod.add_module(k, _QuantizedLeafModule(v))
        elif isinstance(v, torch.Tensor):
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
        elif isinstance(v, (list, tuple)):
            mod.add_module(k, nn.ModuleList([_fill(nn.Module(), t)
                                             for t in v]))
        else:
            mod.add_module(k, _fill(nn.Module(), v))
    return mod


def _module_to_tree(mod: nn.Module):
    if isinstance(mod, _QuantizedLeafModule):
        return QuantizedLeaf(mod.q, mod.scale)
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
        # an int8 model may hold its every weight as buffers
        return next(itertools.chain(self.parameters(),
                                    self.buffers())).device


def cost_model_init(gen: torch.Generator, cfg: CostModelConfig, *,
                    device: str | torch.device = "cuda",
                    dtype=torch.float32) -> CostModel:
    """Random parameters drawn from `gen` (a CPU generator), placed on
    `device`. Raises if `device` is a CUDA device and none is present."""
    dev = resolve_device(device)
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
    elif cfg.gnn == "gat":
        params["gnn"] = G.gat_init(gen, d, max(cfg.gnn_layers, 1),
                                   cfg.gat_heads, directed=cfg.directed,
                                   dtype=dtype)
    elif cfg.gnn != "none":
        raise ValueError(f"unknown gnn {cfg.gnn!r}")
    if cfg.scan_layers and "gnn" in params and params["gnn"]["layers"]:
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
    """A `GraphBatch`/`SparseGraphBatch`/`SegmentedGraphBatch` of numpy
    arrays → the same dataclass holding tensors on `device` (one copy per
    array; a segmented batch's `inner` batch too). Leaves that are
    tensors already (a prefetched batch) move only if they lie elsewhere."""
    def move(a):
        if dataclasses.is_dataclass(a):
            return batch_to_device(a, device)
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dataclasses.replace(batch, **{
        f.name: move(getattr(batch, f.name))
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


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------
def cost_model_apply(params: dict, cfg: CostModelConfig, batch, *,
                     generator: torch.Generator | None = None,
                     training: bool = False) -> torch.Tensor:
    """batch: `GraphBatch`, `SparseGraphBatch` or `SegmentedGraphBatch`
    holding tensors (see `batch_to_device`). Returns predictions [B] (one
    per graph slot). With `training=True` and a `generator` (on the
    batch's device) dropout at rate `cfg.dropout` follows the GNN and the
    Transformer's attention, at the reference's two sites; otherwise the
    forward is deterministic."""
    if cfg.precision == "int8":
        # sparse/segmented + kernels: the GNN tree stays quantized, its f2
        # weights feed the segment_aggregate kernel as int8; everything
        # else (and the dense layout entirely) decodes here
        keep_gnn = (cfg.use_pallas_aggregate and "gnn" in params
                    and not isinstance(batch, F.GraphBatch))
        gnn_q = params["gnn"] if keep_gnn else None
        params = dequantize_tree(params)
        if gnn_q is not None:
            params = dict(params, gnn=gnn_q)
    drop = dict(generator=generator, training=training)
    if isinstance(batch, F.SegmentedGraphBatch):
        return _cost_model_apply_segmented(params, cfg, batch, **drop)
    if isinstance(batch, F.SparseGraphBatch):
        eps = _embed_sparse(params, cfg, batch)
        return _readout_sparse(params, cfg, eps, batch.node_mask,
                               batch.graph_ids, batch.kernel_feats,
                               batch.gather_idx, batch.gather_mask, **drop)
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
    elif cfg.gnn == "gat":
        eps = G.gat_apply(params["gnn"], eps, adj, mask,
                          num_heads=cfg.gat_heads, directed=cfg.directed)

    eps = dropout(eps, cfg.dropout, **drop)
    eps = mlp_apply(params["node_final"], eps, final_act=True)
    eps = eps * mask[..., None]

    if cfg.reduction == "per_node":
        per_node = dense_apply(params["node_head"], eps)[..., 0]  # [B,N]
        y = torch.sum(per_node * mask, dim=1)
        if cfg.kernel_feat_mode == "kernel":
            y = y + dense_apply(params["kernel_head"], kfeats)[..., 0]
        return y

    kappa = R.reduction_apply(params["reduction"], cfg.reduction, eps, mask,
                              transformer_heads=cfg.transformer_heads,
                              dropout_rate=cfg.dropout, **drop)
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
    elif cfg.gnn == "gat":
        eps = G.gat_apply_sparse(params["gnn"], eps, batch.edge_src,
                                 batch.edge_dst, batch.edge_mask, mask,
                                 num_heads=cfg.gat_heads,
                                 directed=cfg.directed)
    return eps


def _cost_model_apply_segmented(params: dict, cfg: CostModelConfig,
                                batch, **drop) -> torch.Tensor:
    """Whole-program forward: the per-node half on the inner segment
    batch, owned-node embeddings scattered back into whole-graph node
    order, then the readout per original graph. Graphs that fit one
    segment go through exactly as on the sparse path."""
    eps_in = _embed_sparse(params, cfg, batch.inner)       # [M_inner, D]
    M = batch.num_nodes
    # halo + padding rows target the dummy slot M and are dropped; owned
    # slots are written exactly once (owned sets partition the graph)
    buf = eps_in.new_zeros((M + 1, eps_in.shape[-1]))
    buf[batch.scatter_idx.long()] = eps_in
    return _readout_sparse(params, cfg, buf[:M], batch.node_mask,
                           batch.graph_ids, batch.kernel_feats,
                           batch.gather_idx, batch.gather_mask, **drop)


def _readout_sparse(params: dict, cfg: CostModelConfig, eps: torch.Tensor,
                    mask: torch.Tensor, gids: torch.Tensor,
                    kfeats: torch.Tensor, gather_idx: torch.Tensor,
                    gather_mask: torch.Tensor, *,
                    generator: torch.Generator | None = None,
                    training: bool = False) -> torch.Tensor:
    """node-final MLP + reduction + head over a flat [M, D] embedding
    buffer with per-node graph ids."""
    num_graphs = kfeats.shape[0]
    kfeats = _mask_kernel_feats(cfg, kfeats)
    gids = gids.long()

    eps = dropout(eps, cfg.dropout, generator=generator, training=training)
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
                                  transformer_heads=cfg.transformer_heads,
                                  dropout_rate=cfg.dropout,
                                  generator=generator, training=training)
    if cfg.kernel_feat_mode == "kernel":
        kappa = torch.cat([kappa, kfeats], dim=-1)
    return dense_apply(params["head"], kappa)[..., 0]
