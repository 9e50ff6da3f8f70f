"""Per-channel int8 weight quantization of a cost model, in PyTorch.

Counterpart of `repro.quant.quantize`. `quantize_params` walks an f32
parameter tree (a `CostModel` or its nested-dict `tree()`) and replaces
every weight matrix (float leaf with ≥ 2 dims and ≥ `min_size` elements:
dense ``w``s, the opcode embedding table, stacked ``[L, ...]`` GNN leaves)
with a `QuantizedLeaf`: int8 values plus per-output-channel scales (per
layer *and* channel for leaves under ``/stacked/``, so the layer loop
slices both fields along L). Small leaves stay f32. The decision is made
on the '/'-joined key path (``gnn/stacked/f2_in/w``,
``gnn/layers/0/f3/w``), the same strings the reference builds.

Serving the result is ``CostModelConfig(precision="int8")`` +
`cost_model_apply`: weights live on the card as int8 and are decoded
per forward; on the sparse layouts with the kernels on, the GNN's f2
weights stay int8 all the way into the `segment_aggregate` kernel.
`CostModelService` accepts a `QuantizedCostModel` directly.

`calibrate_activations` records per-stage abs-maxes of the f32 sparse
forward (the port's plain sparse layer, as the reference runs its own).
The sidecar (`save_quantized`/`load_quantized`) is the reference's
checksummed npz, so a sidecar written by either package loads in the
other bit-exactly.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import gnn as G
from repro_torch.core.device import resolve_device
from repro_torch.core.model import CostModel, CostModelConfig, \
    _mask_kernel_feats, batch_to_device
from repro_torch.nn.core import dense_apply, embedding_apply
from repro_torch.quant.scale import QuantizedLeaf, _amax, amax_scale, \
    dequantize_tree, quantize_int8

SIDECAR_VERSION = 1
DEFAULT_MIN_SIZE = 256


# ----------------------------------------------------------------------------
# Tree walking: '/'-joined key paths, dict keys in sorted order (the order
# in which the reference flattens a tree, so sidecar ids agree too)
# ----------------------------------------------------------------------------
def _as_tree(params):
    return params.tree() if isinstance(params, CostModel) else params


def _flatten(tree, prefix: str = ""):
    """[(key path, leaf)] with `QuantizedLeaf`s as leaves."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def quantize_params(params, model_cfg: CostModelConfig | None = None, *,
                    calib_graphs=None, normalizer=None,
                    min_size: int = DEFAULT_MIN_SIZE
                    ) -> "QuantizedCostModel":
    """Quantize an f32 `CostModel` (or its tree); returns a
    `QuantizedCostModel` on the same device.

    `model_cfg` (default: the model's own config) is embedded, with
    ``precision="int8"``, as the serving config. `calib_graphs`
    (+ `normalizer`) run activation calibration on a corpus sample.

    >>> from repro_torch.core.model import cost_model_init
    >>> cfg = CostModelConfig(hidden_dim=16, opcode_embed_dim=4,
    ...                       reduction="per_node", adjacency="sparse")
    >>> model = cost_model_init(torch.Generator(), cfg, device="cpu")
    >>> qm = quantize_params(model)
    >>> qm.serving_config().precision
    'int8'
    >>> qm.num_quantized > 0 and qm.quantized_bytes() < tree_bytes(model)
    True
    """
    if model_cfg is None and isinstance(params, CostModel):
        model_cfg = params.cfg
    tree = _as_tree(params)

    def one(key, x):
        x = x.detach()
        if x.ndim >= 2 and x.numel() >= min_size and x.is_floating_point():
            # stacked GNN leaves [L, ...]: scales per layer AND channel so
            # the layer loop slices the leading axis of q and scale alike
            keep = {x.ndim - 1}
            if "/stacked/" in f"/{key}/":
                keep.add(0)
            axes = tuple(i for i in range(x.ndim) if i not in keep)
            scale = amax_scale(_amax(x, axes))
            return QuantizedLeaf(quantize_int8(x, scale), scale)
        return x

    with torch.no_grad():
        qtree = _map_with_path(one, tree)
    config = None
    if model_cfg is not None:
        config = dict(model_cfg.to_dict(), precision="int8")
    act_scales = {}
    if calib_graphs is not None:
        if model_cfg is None:
            raise ValueError("calibration needs model_cfg")
        act_scales = calibrate_activations(tree, model_cfg, calib_graphs,
                                           normalizer)
    return QuantizedCostModel(qtree, act_scales=act_scales, config=config)


def dequantize_params(qm: "QuantizedCostModel") -> dict:
    """The f32 view of a quantized model's tree (exact: ``q * scale``)."""
    return dequantize_tree(qm.params)


def calibrate_activations(params, model_cfg: CostModelConfig, graphs,
                          normalizer=None, *,
                          node_budget: int | None = None) -> dict:
    """Per-stage activation abs-maxes from a corpus sample, via the f32
    sparse forward on the parameters' device: ``"f1"`` (the embedding+f1
    output entering the GNN) and ``"gnn_<i>"`` per GraphSAGE hop.
    Returns {name: float amax}."""
    from repro_torch.data.batching import iter_packed_batches

    tree = _as_tree(params)
    device = tree["f1"]["w"].device
    budget = node_budget or 8 * model_cfg.max_nodes
    amaxes: dict[str, float] = {}

    def note(name, x):
        v = float(torch.max(torch.abs(x)))
        amaxes[name] = max(amaxes.get(name, 0.0), v)

    gnn_params = tree.get("gnn")
    layers = (G.unstack_params(gnn_params)["layers"]
              if gnn_params is not None else [])
    with torch.inference_mode():
        for enc, _ in iter_packed_batches(list(graphs), budget, normalizer):
            b = batch_to_device(enc, device)
            mask = b.node_mask
            kfeats = _mask_kernel_feats(model_cfg, b.kernel_feats)
            emb = embedding_apply(tree["opcode_embed"], b.opcodes)
            x = torch.cat([emb, b.node_feats], dim=-1)
            if model_cfg.kernel_feat_mode == "node":
                x = torch.cat([x, kfeats[b.graph_ids.long()]], dim=-1)
            eps = torch.relu(dense_apply(tree["f1"], x)) * mask[:, None]
            note("f1", eps)
            if model_cfg.gnn == "graphsage":
                src, dst = b.edge_src.long(), b.edge_dst.long()
                for i, layer in enumerate(layers):
                    eps = G.sage_layer_apply_sparse(
                        layer, eps, src, dst, b.edge_mask, mask,
                        aggregator=model_cfg.aggregator,
                        directed=model_cfg.directed)
                    note(f"gnn_{i}", eps)
    return amaxes


# ----------------------------------------------------------------------------
# The quantized model
# ----------------------------------------------------------------------------
@dataclass
class QuantizedCostModel:
    """A quantized parameter tree + its calibration + serving config.

    `params` holds `QuantizedLeaf`s at the quantized positions and plain
    f32 tensors elsewhere; `act_scales` are `calibrate_activations`
    abs-maxes; `config` is the serving `CostModelConfig` as a dict
    (``precision`` already ``"int8"``).
    """
    params: dict
    act_scales: dict = field(default_factory=dict)
    config: dict | None = None

    def serving_config(self, base: CostModelConfig | None = None
                       ) -> CostModelConfig:
        """The config to serve this model under (embedded config if
        present, else `base` with ``precision="int8"``)."""
        if self.config is not None:
            return CostModelConfig.from_dict(self.config)
        if base is None:
            raise ValueError("no embedded config; pass the f32 model's "
                             "CostModelConfig as base")
        return CostModelConfig.from_dict(
            dict(base.to_dict(), precision="int8"))

    def model(self, base: CostModelConfig | None = None) -> CostModel:
        """A `CostModel` over this tree (int8 leaves as buffers, no copy),
        under `serving_config(base)`."""
        return CostModel(self.params, self.serving_config(base))

    @property
    def num_quantized(self) -> int:
        return sum(isinstance(x, QuantizedLeaf)
                   for _, x in _flatten(self.params))

    def quantized_bytes(self) -> int:
        """Parameter bytes of the quantized tree: int8 payloads, their
        scales and the remaining f32 leaves."""
        total = 0
        for _, x in _flatten(self.params):
            if isinstance(x, QuantizedLeaf):
                total += x.q.numel() + x.scale.numel() * 4
            else:
                total += x.numel() * x.element_size()
        return total


def tree_bytes(params) -> int:
    """Total bytes of a plain parameter tree (the f32 baseline)."""
    return int(sum(x.numel() * x.element_size()
                   for _, x in _flatten(_as_tree(params))))


# ----------------------------------------------------------------------------
# Checkpoint sidecar: one checksummed npz, the reference's format
# ----------------------------------------------------------------------------
def _digest(arrays: dict) -> str:
    digest = hashlib.sha256()
    for name in sorted(arrays):
        digest.update(name.encode())
        digest.update(arrays[name].tobytes())
    return digest.hexdigest()


def save_quantized(path: str, qm: QuantizedCostModel) -> str:
    """Write `qm` to one npz at `path` (atomic tmp+rename, checksummed
    header). Returns `path`."""
    arrays: dict[str, np.ndarray] = {}
    entries = []
    for i, (key, leaf) in enumerate(_flatten(qm.params)):
        if isinstance(leaf, QuantizedLeaf):
            arrays[f"a{i}.q"] = leaf.q.detach().cpu().numpy()
            arrays[f"a{i}.scale"] = leaf.scale.detach().cpu().numpy() \
                .astype(np.float32)
            entries.append({"key": key, "kind": "int8", "id": f"a{i}"})
        else:
            arrays[f"a{i}.w"] = leaf.detach().cpu().numpy()
            entries.append({"key": key, "kind": "raw", "id": f"a{i}"})
    header = {"format_version": SIDECAR_VERSION,
              "kind": "quantized_cost_model", "config": qm.config,
              "act_scales": {k: float(v) for k, v in qm.act_scales.items()},
              "leaves": entries, "arrays_sha256": _digest(arrays)}
    blob = json.dumps(header, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    tmp = path + f".tmp-{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(blob, np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _insert(root: dict, parts: list[str], value) -> None:
    node = root
    for a in parts[:-1]:
        node = node.setdefault(a, {})
    node[parts[-1]] = value


def _listify(node):
    """{digit-string: v} dicts back into lists (the ``layers`` key-path
    convention)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def load_quantized(path: str, *, device: str | torch.device = "cuda"
                   ) -> QuantizedCostModel:
    """Load a sidecar written by `save_quantized` (of either package)
    onto `device`; bit-exact. Raises ValueError on a wrong format version
    or a checksum mismatch."""
    dev = resolve_device(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if header.get("format_version") != SIDECAR_VERSION:
            raise ValueError(
                f"{path}: sidecar format_version "
                f"{header.get('format_version')!r} != {SIDECAR_VERSION}")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if _digest(arrays) != header["arrays_sha256"]:
        raise ValueError(f"{path}: arrays checksum mismatch")

    def tensor(name):
        return torch.from_numpy(arrays[name]).to(dev)
    root: dict = {}
    for e in header["leaves"]:
        if e["kind"] == "int8":
            leaf = QuantizedLeaf(tensor(e["id"] + ".q"),
                                 tensor(e["id"] + ".scale"))
        else:
            leaf = tensor(e["id"] + ".w")
        _insert(root, e["key"].split("/"), leaf)
    return QuantizedCostModel(_listify(root),
                              act_scales=dict(header["act_scales"]),
                              config=header["config"])
