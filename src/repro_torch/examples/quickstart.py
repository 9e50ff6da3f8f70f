"""Quickstart: train a small learned performance model and use it to rank
tile sizes for a kernel — the paper's core loop.

Counterpart of examples/quickstart.py, on the port: the same corpus,
model, 300 training steps and prints; the model trains and serves on
`--device` (the card by default). The serving step takes the model
config as an argument, so that a caller can serve the trained model
with `use_pallas_aggregate=True` (dense: the `graph_aggregate` kernel);
training stays on the plain route (the kernels have no backward).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.evaluate import eval_tile_task
from repro_torch.core.model import CostModelConfig
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.sampler import TileBatchSampler
from repro_torch.data.synthetic import generate_corpus
from repro_torch.data.tile_dataset import build_tile_dataset, \
    fit_tile_normalizer
from repro_torch.serving import CostModelService
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig

MAX_NODES = 48
STEPS = 300


def build_data(sim: TPUSimulator):
    """1. a corpus of tensor programs + the measurement oracle ("the
    hardware"): (programs, tile dataset, its normalizer)."""
    programs = generate_corpus(16, seed=0)
    dataset = build_tile_dataset(programs, sim, max_configs_per_kernel=12)
    return programs, dataset, fit_tile_normalizer(dataset.records)


def model_config(**overrides) -> CostModelConfig:
    return dataclasses.replace(
        CostModelConfig(gnn="graphsage", reduction="column_wise",
                        hidden_dim=48, opcode_embed_dim=16,
                        max_nodes=MAX_NODES), **overrides)


def make_trainer(dataset, norm, model_cfg: CostModelConfig, device,
                 steps: int) -> CostModelTrainer:
    """2. the learned model and its trainer (pairwise rank loss, Eq. 1)."""
    sampler = TileBatchSampler(dataset.records, norm, kernels_per_batch=3,
                               configs_per_kernel=8, max_nodes=MAX_NODES)
    return CostModelTrainer(
        model_cfg,
        TrainerConfig(task="tile", steps=steps, ckpt_every=0,
                      log_every=100,
                      optim=AdamWConfig(lr=2e-3, schedule="constant")),
        sampler, device=device)


def serve(model, model_cfg: CostModelConfig, norm, dataset,
          sim: TPUSimulator) -> dict:
    """3-4. serve the trained model (docs/SERVING.md) and rank tile sizes
    for one kernel through the cached, coalescing service; then the
    whole test set's quality (Tile-Size APE, Eq. 2 + Kendall tau)."""
    service = CostModelService(model, model_cfg, norm,
                               max_nodes=MAX_NODES, chunk=32)
    scorer = service.tile_scorer()
    rec = max(dataset.records, key=lambda r: len(r.tiles))
    scores = scorer(rec.kernel, rec.tiles)
    pred_best = rec.tiles[int(np.argmin(scores))]
    true_best = rec.tiles[int(np.argmin(rec.runtimes))]
    return {"service": service, "rec": rec, "scores": scores,
            "pred_best": pred_best, "true_best": true_best,
            "pred_runtime": sim.measure(rec.kernel.with_tile(pred_best)),
            "metrics": eval_tile_task(dataset, scorer),
            "stats": service.stats()}


def report_data(programs, dataset) -> None:
    print(f"corpus: {len(programs)} programs, {len(dataset.records)} "
          f"kernels, {dataset.num_samples} (kernel, tile) samples")


def report_serving(s: dict) -> None:
    rec = s["rec"]
    print(f"kernel {rec.kernel.name}: {len(rec.tiles)} candidate tiles")
    print(f"  model's pick {s['pred_best']} -> {s['pred_runtime']:.3e}s")
    print(f"  true best    {s['true_best']} -> {rec.runtimes.min():.3e}s")
    m = s["metrics"]
    print(f"mean tile APE {m['mean_ape']:.2f}%  "
          f"mean Kendall tau {m['mean_kendall']:.3f}")
    # the service cached every (kernel, tile) query above; step 3's
    # kernel hit
    st = s["stats"]
    print(f"service: {st.graphs} queries, hit rate {st.hit_rate:.1%}, "
          f"{st.flushes} flushes, p50 {st.latency_p50_ms:.1f}ms/call")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sim = TPUSimulator()
    programs, dataset, norm = build_data(sim)
    report_data(programs, dataset)
    mc = model_config()
    trainer = make_trainer(dataset, norm, mc, device, STEPS)
    res = trainer.run(resume=False)
    print(f"trained {STEPS} steps, final rank loss {res['loss']:.4f}")
    served = serve(trainer.model, mc, norm, dataset, sim)
    report_serving(served)
    return {"sim": sim, "dataset": dataset, "norm": norm, "model_cfg": mc,
            "trainer": trainer, "served": served}


if __name__ == "__main__":
    main()
