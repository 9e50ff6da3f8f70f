"""Batched inference of the cost model (counterpart of the prediction half
of `repro.core.evaluate`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.core.model import CostModel, CostModelConfig, \
    batch_to_device, cost_model_apply


def make_predict_fn(model_cfg: CostModelConfig):
    """`predict(model, batch) -> np.ndarray [B]`: moves the numpy batch to
    the model's device once, runs the forward under inference mode and
    brings the predictions back to the host."""
    def predict(model: CostModel, batch) -> np.ndarray:
        with torch.inference_mode():
            tb = batch_to_device(batch, model.device)
            y = cost_model_apply(model.tree(), model_cfg, tb)
            return y.float().cpu().numpy()
    return predict


def predict_kernels(model: CostModel, model_cfg: CostModelConfig, graphs,
                    normalizer, *, max_nodes: int = 64, chunk: int = 128,
                    predict_fn=None, adjacency: str | None = None,
                    node_budget: int | None = None) -> np.ndarray:
    """Predict scores for a list of KernelGraphs (batched inference), on
    the model's device.

    dense     — fixed-size chunks padded to `chunk` graphs × `max_nodes`
                nodes.
    sparse    — kernels packed into flat buffers of ≤ `node_budget` total
                nodes (default 8 × max_nodes) with pow2-bucketed
                capacities. Kernels beyond the budget still score
                (oversized singleton packs).
    segmented — whole-program graphs of any size: each graph segmented
                into ≤ `node_budget` blocks (default 8 × max_nodes) and
                reassembled before readout; chunks of `chunk` graphs per
                device batch.

    `adjacency` defaults to `model_cfg.adjacency`. This is the direct,
    uncached path; `repro_torch.serving.CostModelService` adds the
    prediction cache and request coalescing on the same encoders.
    """
    if adjacency is None:
        adjacency = model_cfg.adjacency
    predict = predict_fn or make_predict_fn(model_cfg)
    if not len(graphs):
        return np.zeros((0,), np.float32)
    if adjacency == "sparse":
        from repro_torch.data.batching import iter_packed_batches
        budget = node_budget or 8 * max_nodes
        out = np.zeros((len(graphs),), np.float32)
        for enc, idx in iter_packed_batches(graphs, budget, normalizer):
            preds = np.asarray(predict(model, enc))
            out[idx] = preds[:len(idx)]
        return out
    if adjacency == "segmented":
        from repro_torch.data.batching import encode_segmented
        budget = node_budget or 8 * max_nodes
        out = []
        for i in range(0, len(graphs), chunk):
            part = graphs[i:i + chunk]
            enc = encode_segmented(part, budget, normalizer)
            preds = np.asarray(predict(model, enc))
            out.append(preds[:len(part)])
        return np.concatenate(out)
    out = []
    for i in range(0, len(graphs), chunk):
        part = graphs[i:i + chunk]
        pad = chunk - len(part)
        enc = F.encode_batch(part + [part[-1]] * pad, max_nodes, normalizer)
        preds = np.asarray(predict(model, enc))
        out.append(preds[:len(part)])
    return np.concatenate(out) if out else np.zeros((0,), np.float32)
