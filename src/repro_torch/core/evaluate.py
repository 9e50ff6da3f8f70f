"""Batched evaluation of cost models against the measurement oracle
(counterpart of `repro.core.evaluate`): batched inference on the model's
device, and the paper's Table-2/8 style per-program metrics."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.core.analytical import AnalyticalModel, predict_scaled
from repro_torch.core.metrics import (
    kendall_tau,
    mape,
    program_kendall,
    tile_size_ape,
)
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


# ----------------------------------------------------------------------------
# Tile-size task (Table 2 left): Tile-Size APE + per-kernel Kendall τ
# ----------------------------------------------------------------------------
def eval_tile_program(records, scorer) -> dict:
    """records: TileKernelRecords of ONE program.
    scorer(kernel, tiles) -> predicted scores (lower = faster)."""
    per_kernel = []
    for r in records:
        pred = scorer(r.kernel, r.tiles)
        per_kernel.append({"true": r.runtimes, "pred": pred})
    return {
        "ape": tile_size_ape(per_kernel),
        "kendall": program_kendall(per_kernel),
    }


def learned_tile_scorer(model, model_cfg, normalizer, *, max_nodes=64,
                        chunk=128, adjacency=None, node_budget=None,
                        service=None, cache_capacity=65536):
    """Tile scorer backed by a `repro_torch.search.LearnedEstimator` (and so by
    a `repro_torch.serving.CostModelService`): every (kernel, tile) query goes
    through the content-addressed prediction cache + coalescer, so
    revisited candidates (top-k re-ranks, repeated eval sweeps) are scored
    once. Pass an existing `service` to share its cache across scorers;
    otherwise one is built from these arguments (`cache_capacity=0` falls
    back to direct uncached scoring)."""
    from repro_torch.search import LearnedEstimator
    est = LearnedEstimator.from_params(model, model_cfg, normalizer,
                                       max_nodes=max_nodes, chunk=chunk,
                                       adjacency=adjacency,
                                       node_budget=node_budget,
                                       service=service,
                                       cache_capacity=cache_capacity)
    return est.tile_scorer()


def analytical_tile_scorer(model: AnalyticalModel):
    def scorer(kernel, tiles):
        return np.array([model.predict(kernel, t) for t in tiles])
    return scorer


def eval_tile_task(dataset, scorer) -> dict:
    """Returns per-program metrics + median/mean summary (Table 2 style)."""
    per_prog = {}
    for prog, recs in dataset.by_program().items():
        per_prog[prog] = eval_tile_program(recs, scorer)
    apes = [m["ape"] for m in per_prog.values()]
    taus = [m["kendall"] for m in per_prog.values()]
    return {
        "per_program": per_prog,
        "median_ape": float(np.median(apes)) if apes else float("nan"),
        "mean_ape": float(np.mean(apes)) if apes else float("nan"),
        "median_kendall": float(np.median(taus)) if taus else float("nan"),
        "mean_kendall": float(np.mean(taus)) if taus else float("nan"),
    }


# ----------------------------------------------------------------------------
# Fusion task (Table 2 right): MAPE + Kendall τ on absolute runtimes
# ----------------------------------------------------------------------------
def eval_fusion_task(dataset, predict_runtimes, *,
                     min_runtime: float = 0.0) -> dict:
    """predict_runtimes(kernels) -> seconds. Kernels filtered to
    runtime >= min_runtime (the paper reports ≥5µs separately)."""
    per_prog = {}
    for prog, recs in dataset.by_program().items():
        recs = [r for r in recs if r.runtime >= min_runtime]
        if not recs:
            continue
        true = np.array([r.runtime for r in recs])
        pred = predict_runtimes([r.kernel for r in recs])
        per_prog[prog] = {
            "mape": mape(pred, true),
            "kendall": kendall_tau(pred, true),
            "n": len(recs),
        }
    mapes = [m["mape"] for m in per_prog.values()]
    taus = [m["kendall"] for m in per_prog.values()]
    return {
        "per_program": per_prog,
        "median_mape": float(np.median(mapes)) if mapes else float("nan"),
        "mean_mape": float(np.mean(mapes)) if mapes else float("nan"),
        "median_kendall": float(np.median(taus)) if taus else float("nan"),
        "mean_kendall": float(np.mean(taus)) if taus else float("nan"),
    }


def learned_runtime_predictor(model, model_cfg, normalizer, *,
                              max_nodes=64, chunk=128, adjacency=None,
                              node_budget=None, service=None,
                              cache_capacity=65536):
    """Fusion-task model predicts log-runtime; exponentiate. Scores
    through a `repro_torch.search.LearnedEstimator` (see `learned_tile_scorer`
    for the `service`/`cache_capacity` contract)."""
    from repro_torch.search import LearnedEstimator
    est = LearnedEstimator.from_params(model, model_cfg, normalizer,
                                       max_nodes=max_nodes, chunk=chunk,
                                       adjacency=adjacency,
                                       node_budget=node_budget,
                                       service=service,
                                       cache_capacity=cache_capacity)
    return est.runtime_predictor()


def analytical_runtime_predictor(model: AnalyticalModel, coeffs: dict):
    def predict_runtimes(kernels):
        return np.array([predict_scaled(model, coeffs, k) for k in kernels])
    return predict_runtimes
