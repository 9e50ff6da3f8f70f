"""GraphSAGE and GAT over batched kernel graphs (paper §3.2).

Counterpart of `repro.core.gnn`. Direction-aware: incoming and outgoing
edges aggregate through separate feedforward modules ('Undirected'
ablation shares them). GAT runs on plain PyTorch ops in every layout, as
the reference runs it outside any Pallas kernel; its sparse segment
sums are `index_add_`, atomics on the card, so sparse GAT is not
bit-reproducible there.

Two aggregation backends share one parameter tree:

* dense — a masked-adjacency product `adj[b, d, s] @ h[b, s, :]` over a
  `GraphBatch`; with `use_kernel` the transform+aggregate goes through
  the hand-written `kernels.graph_aggregate` CUDA kernel.
* sparse — `index_add_` over a packed edge list (`SparseGraphBatch`);
  with `use_kernel` through the `kernels.segment_aggregate` CUDA kernel.

On CPU tensors the kernel wrappers run their plain PyTorch versions.
Both layer-stack layouts of the reference are accepted: unrolled
(`{"layers": [layer_0, ...]}`) and stacked (`{"stacked": tree}`, leaves
with a leading layer axis), run as one Python loop over the layers. A
leaf may be an int8 `QuantizedLeaf`: the layer loop slices its `q` and
`scale` alike, and the kernel-backed sparse hop feeds int8 f2 weights to
the kernel's int8 variant.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from repro_torch.kernels.graph_aggregate import graph_aggregate
from repro_torch.kernels.segment_aggregate import (
    EdgeCSR,
    edge_csr,
    segment_aggregate,
)
from repro_torch.nn.core import dense_apply, dense_init, l2_normalize
from repro_torch.quant.scale import QuantizedLeaf, leaf_f32


# ----------------------------------------------------------------------------
# Layer-stack layouts
# ----------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, QuantizedLeaf):
        return QuantizedLeaf(fn(tree.q), fn(tree.scale))
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


def _f2_qs(leaf: dict):
    """(weights, per-output-channel scale) of one f2 module for the fused
    kernel: int8 q + its scale for a `QuantizedLeaf`, the f32 weight with
    unit scales otherwise (the kernel's dequant is then a no-op
    multiply)."""
    w = leaf["w"]
    if isinstance(w, QuantizedLeaf):
        return w.q, w.scale.reshape(1, -1)
    return w, torch.ones((1, w.shape[-1]), dtype=torch.float32,
                         device=w.device)


def sage_layer_apply_sparse_q(params: dict, eps: torch.Tensor,
                              edges_in: EdgeCSR, edges_out: EdgeCSR,
                              node_mask: torch.Tensor, *,
                              aggregator: str = "mean",
                              directed: bool = True) -> torch.Tensor:
    """`sage_layer_apply_sparse` with the transform+aggregate fused into
    the `segment_aggregate` kernel. The f2 weights may be int8
    `QuantizedLeaf`s (they reach the kernel as int8 with their scales) or
    plain f32; f3 is dequantized outside the kernel either way.
    `edges_in` groups the edges by destination, `edges_out` by source."""
    mean = aggregator == "mean"

    def fused(leaf, edges):
        w, scale = _f2_qs(leaf)
        return segment_aggregate(eps, w, scale, edges, node_mask,
                                 act="relu", mean=mean)

    agg_in = fused(params["f2_in"], edges_in)
    parts = [eps, agg_in]
    if directed:
        parts.append(fused(params["f2_out"], edges_out))
    else:
        agg_out = fused(params["f2_in"], edges_out)
        parts[1] = 0.5 * (agg_in + agg_out)
    f3 = {"f3": {"w": leaf_f32(params["f3"]["w"])}}
    return _sage_finish(f3, parts, node_mask)


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


# ----------------------------------------------------------------------------
# GAT
# ----------------------------------------------------------------------------
def gat_layer_init(gen: torch.Generator, dim: int, num_heads: int, *,
                   directed: bool, dtype=torch.float32) -> dict:
    assert dim % num_heads == 0
    hd = dim // num_heads

    def attn():
        return torch.randn((num_heads, hd), generator=gen, dtype=dtype) * 0.1
    params = {
        "w_in": dense_init(gen, dim, dim, bias=False, dtype=dtype),
        "a_src_in": attn(),
        "a_dst_in": attn(),
        "proj": dense_init(gen, dim * (2 if directed else 1), dim,
                           bias=False, dtype=dtype),
    }
    if directed:
        params["w_out"] = dense_init(gen, dim, dim, bias=False, dtype=dtype)
        params["a_src_out"] = attn()
        # an independent copy, as in the reference: one tensor under two
        # names would be one parameter, moved by one update for both
        params["a_dst_out"] = params["a_dst_in"].clone()
    return params


def _gat_attend(h: torch.Tensor, adj: torch.Tensor, a_src: torch.Tensor,
                a_dst: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Masked multi-head attention aggregation over in-edges of `adj`."""
    B, N, D = h.shape
    hd = D // num_heads
    hh = h.reshape(B, N, num_heads, hd)
    e_src = torch.einsum("bnhd,hd->bnh", hh, a_src)  # src's score share
    e_dst = torch.einsum("bnhd,hd->bnh", hh, a_dst)
    # logits[b, h, d, s] = leaky_relu(e_dst[d] + e_src[s])
    logits = TF.leaky_relu(
        e_dst.transpose(1, 2)[:, :, :, None] +
        e_src.transpose(1, 2)[:, :, None, :], 0.2)
    neg = torch.finfo(logits.dtype).min
    mask = adj[:, None, :, :] > 0
    logits = torch.where(mask, logits, neg)
    alpha = torch.softmax(logits, dim=-1)
    # rows with no in-edges: their uniform softmax is zeroed afterwards
    alpha = torch.where(mask.any(dim=-1, keepdim=True), alpha, 0.0)
    out = torch.einsum("bhds,bshx->bdhx", alpha, hh)
    return out.reshape(B, N, D)


def gat_layer_apply(params: dict, eps: torch.Tensor, adj: torch.Tensor,
                    node_mask: torch.Tensor, *, num_heads: int,
                    directed: bool = True) -> torch.Tensor:
    h_in = dense_apply(params["w_in"], eps)
    agg_in = _gat_attend(h_in, adj, params["a_src_in"], params["a_dst_in"],
                         num_heads)
    if directed:
        h_out = dense_apply(params["w_out"], eps)
        agg_out = _gat_attend(h_out, adj.transpose(-1, -2),
                              params["a_src_out"], params["a_dst_out"],
                              num_heads)
        agg = torch.cat([agg_in, agg_out], dim=-1)
    else:
        sym = torch.maximum(adj, adj.transpose(-1, -2))
        agg = _gat_attend(h_in, sym, params["a_src_in"], params["a_dst_in"],
                          num_heads)
    h = dense_apply(params["proj"], agg)
    h = TF.elu(h) + eps          # residual keeps training stable
    return h * node_mask[..., None]


def gat_init(gen: torch.Generator, dim: int, num_layers: int,
             num_heads: int, *, directed: bool = True,
             dtype=torch.float32) -> dict:
    return {"layers": [gat_layer_init(gen, dim, num_heads,
                                      directed=directed, dtype=dtype)
                       for _ in range(num_layers)]}


def gat_apply(params: dict, eps: torch.Tensor, adj: torch.Tensor,
              node_mask: torch.Tensor, *, num_heads: int,
              directed: bool = True) -> torch.Tensor:
    def layer_fn(layer, h):
        return gat_layer_apply(layer, h, adj, node_mask, num_heads=num_heads,
                               directed=directed)
    return _apply_stack(params, eps, layer_fn)


def _gat_attend_sparse(h: torch.Tensor, edge_src: torch.Tensor,
                       edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                       a_src: torch.Tensor, a_dst: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """Segment-softmax attention over in-edges: sparse twin of
    `_gat_attend`. h: [M, D]; edges (int64) index the node buffer. The
    softmax per (dst, head) segment is max-shifted; destinations with no
    in-edges get a zero output, as on the dense path."""
    M, D = h.shape
    hd = D // num_heads
    hh = h.reshape(M, num_heads, hd)
    e_src = torch.einsum("mhd,hd->mh", hh, a_src)
    e_dst = torch.einsum("mhd,hd->mh", hh, a_dst)
    logits = TF.leaky_relu(e_dst[edge_dst] + e_src[edge_src], 0.2)
    neg = torch.finfo(logits.dtype).min
    z = torch.where(edge_mask[:, None] > 0, logits, neg)
    # segment max: empty segments keep the fill, as the reference's
    # maximum(segment_max, neg) leaves them
    zmax = torch.full((M, num_heads), neg, dtype=z.dtype, device=z.device)
    zmax = zmax.scatter_reduce(0, edge_dst[:, None].expand(-1, num_heads),
                               z, reduce="amax", include_self=False)
    zmax = torch.clamp(zmax, min=neg)
    num = torch.exp(z - zmax[edge_dst]) * edge_mask[:, None]       # [E, H]
    den = torch.zeros_like(zmax).index_add(0, edge_dst, num)       # [M, H]
    alpha = num / torch.clamp(den[edge_dst], min=1e-30)
    out = hh.new_zeros((M, num_heads, hd)).index_add(
        0, edge_dst, alpha[:, :, None] * hh[edge_src])             # [M,H,hd]
    return out.reshape(M, D)


def gat_layer_apply_sparse(params: dict, eps: torch.Tensor,
                           edge_src: torch.Tensor, edge_dst: torch.Tensor,
                           edge_mask: torch.Tensor, node_mask: torch.Tensor,
                           *, num_heads: int,
                           directed: bool = True) -> torch.Tensor:
    if not directed:
        # as the reference: the symmetrized edge set is not deduplicated
        # on the sparse layout; the ablation stays on the dense path
        raise NotImplementedError(
            "undirected GAT is dense-only; use adjacency='dense'")
    h_in = dense_apply(params["w_in"], eps)
    agg_in = _gat_attend_sparse(h_in, edge_src, edge_dst, edge_mask,
                                params["a_src_in"], params["a_dst_in"],
                                num_heads)
    h_out = dense_apply(params["w_out"], eps)
    agg_out = _gat_attend_sparse(h_out, edge_dst, edge_src, edge_mask,
                                 params["a_src_out"], params["a_dst_out"],
                                 num_heads)
    agg = torch.cat([agg_in, agg_out], dim=-1)
    h = dense_apply(params["proj"], agg)
    h = TF.elu(h) + eps
    return h * node_mask[:, None]


def gat_apply_sparse(params: dict, eps: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                     node_mask: torch.Tensor, *, num_heads: int,
                     directed: bool = True) -> torch.Tensor:
    src, dst = edge_src.long(), edge_dst.long()

    def layer_fn(layer, h):
        return gat_layer_apply_sparse(layer, h, src, dst, edge_mask,
                                      node_mask, num_heads=num_heads,
                                      directed=directed)
    return _apply_stack(params, eps, layer_fn)
