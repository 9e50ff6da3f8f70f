"""GraphSAGE over batched kernel graphs (paper §3.2).

Counterpart of `repro.core.gnn`, GraphSAGE only (GAT is not ported yet).
Direction-aware: incoming and outgoing edges aggregate through separate
feedforward modules ('Undirected' ablation shares them).

Two aggregation backends share one parameter tree:

* dense — a masked-adjacency product `adj[b, d, s] @ h[b, s, :]` over a
  `GraphBatch`; with `use_kernel` the transform+aggregate goes through
  the hand-written `kernels.graph_aggregate` CUDA kernel.
* sparse — `index_add_` over a packed edge list (`SparseGraphBatch`);
  with `use_kernel` through the `kernels.segment_aggregate` CUDA kernel.

On CPU tensors the kernel wrappers run their plain PyTorch versions.
Both layer-stack layouts of the reference are accepted: unrolled
(`{"layers": [layer_0, ...]}`) and stacked (`{"stacked": tree}`, leaves
with a leading layer axis), run as one Python loop over the layers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.graph_aggregate import graph_aggregate
from repro_torch.kernels.segment_aggregate import (
    EdgeCSR,
    edge_csr,
    segment_aggregate,
)
from repro_torch.nn.core import dense_apply, dense_init, l2_normalize


# ----------------------------------------------------------------------------
# Layer-stack layouts
# ----------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def stack_params(params: dict) -> dict:
    """Unrolled GNN tree (``{"layers": [...]}``) → stacked layout
    (``{"stacked": tree}``, leaves ``[L, ...]``). Exact."""
    if "stacked" in params:
        return params
    layers = params["layers"]
    if not layers:
        raise ValueError("cannot stack an empty layer list")

    def zip_trees(trees):
        if isinstance(trees[0], dict):
            return {k: zip_trees([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees, dim=0)
    return {"stacked": zip_trees(layers)}


def unstack_params(params: dict) -> dict:
    """Inverse of `stack_params` (pure slicing)."""
    if "layers" in params:
        return params
    stacked = params["stacked"]
    n = int(_first_leaf(stacked).shape[0])
    return {"layers": [_tree_map(lambda x, i=i: x[i], stacked)
                       for i in range(n)]}


def _apply_stack(params: dict, eps: torch.Tensor, layer_fn) -> torch.Tensor:
    layers = unstack_params(params)["layers"]
    for layer in layers:
        eps = layer_fn(layer, eps)
    return eps


# ----------------------------------------------------------------------------
# GraphSAGE
# ----------------------------------------------------------------------------
def sage_layer_init(gen: torch.Generator, dim: int, *, directed: bool,
                    dtype=torch.float32) -> dict:
    params = {
        "f2_in": dense_init(gen, dim, dim, bias=False, dtype=dtype),
        # concat(self, agg_in[, agg_out]) -> dim
        "f3": dense_init(gen, dim * (3 if directed else 2), dim, bias=False,
                         dtype=dtype),
    }
    if directed:
        params["f2_out"] = dense_init(gen, dim, dim, bias=False, dtype=dtype)
    return params


def sage_init(gen: torch.Generator, dim: int, num_layers: int, *,
              directed: bool = True, dtype=torch.float32) -> dict:
    return {"layers": [sage_layer_init(gen, dim, directed=directed,
                                       dtype=dtype)
                       for _ in range(num_layers)]}


def _sage_finish(params: dict, parts: list, node_mask: torch.Tensor):
    h = torch.relu(dense_apply(params["f3"], torch.cat(parts, dim=-1)))
    return l2_normalize(h, dim=-1) * node_mask[..., None]


def _aggregate(adj: torch.Tensor, h: torch.Tensor, node_mask: torch.Tensor,
               aggregator: str) -> torch.Tensor:
    """adj: [B,N,N] (adj[b,d,s]); h: [B,N,D]; returns [B,N,D] per-dst agg."""
    agg = torch.bmm(adj, h * node_mask[..., None])
    if aggregator == "mean":
        agg = agg / torch.clamp(adj.sum(dim=-1, keepdim=True), min=1.0)
    return agg


def sage_layer_apply(params: dict, eps: torch.Tensor, adj: torch.Tensor,
                     adj_t: torch.Tensor, node_mask: torch.Tensor, *,
                     aggregator: str = "mean", directed: bool = True,
                     use_kernel: bool = False) -> torch.Tensor:
    """One dense GraphSAGE hop:
    eps_i^k = l2( f3( concat(eps_i, Σ_{j∈in(i)} f2_in(eps_j)
                              [, Σ_{j∈out(i)} f2_out(eps_j)]) ) )
    `adj_t` is `adj` transposed (out-edges), made once per batch."""
    if use_kernel:
        mean = aggregator == "mean"
        agg_in = graph_aggregate(adj, eps, params["f2_in"]["w"],
                                 act="relu", mean=mean)
        parts = [eps, agg_in]
        if directed:
            parts.append(graph_aggregate(adj_t, eps, params["f2_out"]["w"],
                                         act="relu", mean=mean))
        else:
            agg_out = graph_aggregate(adj_t, eps, params["f2_in"]["w"],
                                      act="relu", mean=mean)
            parts[1] = 0.5 * (agg_in + agg_out)
        return _sage_finish(params, parts, node_mask)

    msg_in = torch.relu(dense_apply(params["f2_in"], eps))
    agg_in = _aggregate(adj, msg_in, node_mask, aggregator)
    parts = [eps, agg_in]
    if directed:
        msg_out = torch.relu(dense_apply(params["f2_out"], eps))
        parts.append(_aggregate(adj_t, msg_out, node_mask, aggregator))
    else:
        # undirected ablation: same module, symmetrized adjacency
        agg_out = _aggregate(adj_t, msg_in, node_mask, aggregator)
        parts[1] = 0.5 * (agg_in + agg_out)
    return _sage_finish(params, parts, node_mask)


def sage_apply(params: dict, eps: torch.Tensor, adj: torch.Tensor,
               node_mask: torch.Tensor, *, aggregator: str = "mean",
               directed: bool = True,
               use_kernel: bool = False) -> torch.Tensor:
    adj_t = adj.transpose(1, 2).contiguous()

    def layer_fn(layer, h):
        return sage_layer_apply(layer, h, adj, adj_t, node_mask,
                                aggregator=aggregator, directed=directed,
                                use_kernel=use_kernel)
    return _apply_stack(params, eps, layer_fn)


# ----------------------------------------------------------------------------
# Sparse (segment-sum) backend — flat [M, D] node buffer + packed edge list
# ----------------------------------------------------------------------------
def _segment_aggregate(msg: torch.Tensor, gather: torch.Tensor,
                       scatter: torch.Tensor, edge_mask: torch.Tensor,
                       node_mask: torch.Tensor,
                       aggregator: str) -> torch.Tensor:
    """Aggregate per-node messages along edges: message read at `gather`,
    summed into `scatter`; returns [M, D]."""
    m = msg * node_mask[:, None]
    agg = torch.zeros_like(msg).index_add_(
        0, scatter, m[gather] * edge_mask[:, None])
    if aggregator == "mean":
        deg = torch.zeros_like(node_mask).index_add_(0, scatter, edge_mask)
        agg = agg / torch.clamp(deg, min=1.0)[:, None]
    return agg


def sage_layer_apply_sparse(params: dict, eps: torch.Tensor,
                            edge_src: torch.Tensor, edge_dst: torch.Tensor,
                            edge_mask: torch.Tensor, node_mask: torch.Tensor,
                            *, aggregator: str = "mean",
                            directed: bool = True) -> torch.Tensor:
    """Sparse twin of `sage_layer_apply` over a flat node buffer."""
    msg_in = torch.relu(dense_apply(params["f2_in"], eps))
    agg_in = _segment_aggregate(msg_in, edge_src, edge_dst, edge_mask,
                                node_mask, aggregator)
    parts = [eps, agg_in]
    if directed:
        msg_out = torch.relu(dense_apply(params["f2_out"], eps))
        parts.append(_segment_aggregate(msg_out, edge_dst, edge_src,
                                        edge_mask, node_mask, aggregator))
    else:
        agg_out = _segment_aggregate(msg_in, edge_dst, edge_src, edge_mask,
                                     node_mask, aggregator)
        parts[1] = 0.5 * (agg_in + agg_out)
    return _sage_finish(params, parts, node_mask)


def sage_layer_apply_sparse_q(params: dict, eps: torch.Tensor,
                              edges_in: EdgeCSR, edges_out: EdgeCSR,
                              node_mask: torch.Tensor, *,
                              aggregator: str = "mean",
                              directed: bool = True) -> torch.Tensor:
    """`sage_layer_apply_sparse` with the transform+aggregate fused into
    the `segment_aggregate` kernel. fp32 f2 weights with unit scales (the
    reference's `_f2_qs` for plain weights); int8 weights are not ported
    yet. `edges_in` groups the edges by destination, `edges_out` by
    source."""
    mean = aggregator == "mean"

    def fused(leaf, edges):
        w = leaf["w"]
        scale = torch.ones((w.shape[-1],), dtype=torch.float32,
                           device=w.device)
        return segment_aggregate(eps, w, scale, edges, node_mask,
                                 act="relu", mean=mean)

    agg_in = fused(params["f2_in"], edges_in)
    parts = [eps, agg_in]
    if directed:
        parts.append(fused(params["f2_out"], edges_out))
    else:
        agg_out = fused(params["f2_in"], edges_out)
        parts[1] = 0.5 * (agg_in + agg_out)
    return _sage_finish(params, parts, node_mask)


def sage_apply_sparse(params: dict, eps: torch.Tensor,
                      edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_mask: torch.Tensor, node_mask: torch.Tensor, *,
                      aggregator: str = "mean", directed: bool = True,
                      use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        # group the edges once per direction; every hop reuses them
        M = eps.shape[0]
        edges_in = edge_csr(edge_src, edge_dst, edge_mask, M)
        edges_out = edge_csr(edge_dst, edge_src, edge_mask, M)

        def layer_fn(layer, h):
            return sage_layer_apply_sparse_q(layer, h, edges_in, edges_out,
                                             node_mask,
                                             aggregator=aggregator,
                                             directed=directed)
        return _apply_stack(params, eps, layer_fn)

    src, dst = edge_src.long(), edge_dst.long()

    def layer_fn(layer, h):
        return sage_layer_apply_sparse(layer, h, src, dst, edge_mask,
                                       node_mask, aggregator=aggregator,
                                       directed=directed)
    return _apply_stack(params, eps, layer_fn)
