"""Incremental retraining: warm-start fine-tune on base+delta streams.

Counterpart of `repro.flywheel.retrain`. TLP (PAPERS.md) motivates the
shape of this: adapting an existing checkpoint on fresh measurements
reaches the from-scratch model's quality in a fraction of the steps,
which is what makes per-round retraining affordable inside a search
loop. `fine_tune` wires the pieces the trainer already has —
`CostModelTrainer.warm_start` (params + AdamW moments from the previous
round's checkpoint, optimizer step counter reset so
`AdamWConfig.warmup_steps` re-warms the LR) over a `TileBatchSampler` on
any record sequence, typically a `StreamingCorpus.with_deltas()` chained
view.

`tile_val_loss` is the deterministic yardstick both flywheel gates use:
the pairwise rank loss of deterministic predictions over a fixed set of
sampler batches — no dropout, no step dependence, directly comparable
across models and rounds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.losses import pairwise_rank_loss
from repro_torch.core.model import CostModel, CostModelConfig
from repro_torch.data.sampler import TileBatchSampler
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig


def tile_val_loss(model: CostModel, model_cfg: CostModelConfig, sampler, *,
                  batches: int = 8, rank_phi: str = "hinge",
                  predict_fn=None) -> float:
    """Mean deterministic pairwise rank loss over `sampler.batch(0..b)`.

    Batch purity (`batch(step)` is a pure function of step) makes this a
    fixed eval set: every call scores the same batches, so two models'
    losses — or one model's loss across fine-tune rounds — are exactly
    comparable. The forward runs on the model's device under `model_cfg`
    (pass a `predict_fn` from `core.evaluate.make_predict_fn` to reuse
    one); the loss is taken on the host in f32.
    """
    if predict_fn is None:
        from repro_torch.core.evaluate import make_predict_fn
        predict_fn = make_predict_fn(model_cfg)
    total = 0.0
    for step in range(batches):
        b = sampler.batch(step)
        preds = predict_fn(model, b.graphs)
        gids = getattr(b, "group_ids", np.zeros_like(b.targets, np.int32))
        total += float(pairwise_rank_loss(
            torch.from_numpy(np.asarray(preds)),
            torch.from_numpy(np.asarray(b.targets)),
            torch.from_numpy(np.asarray(gids)),
            torch.from_numpy(np.asarray(b.valid)), phi=rank_phi))
    return total / max(batches, 1)


@dataclass
class FineTuneResult:
    params: CostModel              # the fine-tuned model (the trainer's)
    steps: int
    from_step: int                 # checkpoint step warm-started from
    final_train_loss: float
    val_history: list = field(default_factory=list)   # (step, val_loss)


def fine_tune(records, normalizer, model_cfg: CostModelConfig, *,
              warm_start_dir: str, steps: int, ckpt_dir: str = "",
              lr: float = 1e-3, warmup_steps: int = 20, seed: int = 0,
              kernels_per_batch: int = 4, configs_per_kernel: int = 8,
              reset_opt_step: bool = True, val_sampler=None,
              eval_every: int = 0, val_batches: int = 8,
              rank_phi: str = "hinge", prefetch: int = 0,
              prefetch_device_put: bool = False, log_every: int = 0,
              metrics_path: str = "",
              device: str | torch.device = "cuda") -> FineTuneResult:
    """Warm-start fine-tune the tile cost model on `records`, on `device`.

    `records` is any record sequence the samplers accept — in the
    flywheel, the `with_deltas()` chained view of the measurement store.
    Restores params + optimizer moments from the latest checkpoint in
    `warm_start_dir` (either package's), resets the optimizer step
    counter (unless `reset_opt_step=False`) so the LR re-warms over
    `warmup_steps`, and trains `steps` steps from a fresh step-0
    (``resume=False`` — a previous round's checkpoint in `ckpt_dir` must
    not short-circuit the run). With `val_sampler` + `eval_every`,
    records a `tile_val_loss` trajectory in ``val_history``.

    The port's aggregation kernels have no backward (its trainer refuses
    them; the JAX trainer takes them on the dense layout), so the
    training forward runs ``use_pallas_aggregate=False`` whatever
    `model_cfg` says: the same weights through the plain route. The
    validation forward and the returned model's scoring keep `model_cfg`
    as given, kernels on if it asks for them.

    `prefetch` / `prefetch_device_put` are the trainer's input pipeline
    (`TrainerConfig`); the losses are the same with it on. `log_every`
    (0: a quarter of `steps`) and `metrics_path` are the trainer's
    metrics stream, one JSON line per logged step.
    """
    train_cfg = dataclasses.replace(model_cfg, use_pallas_aggregate=False)
    sampler = TileBatchSampler(
        records, normalizer, kernels_per_batch=kernels_per_batch,
        configs_per_kernel=configs_per_kernel,
        max_nodes=model_cfg.max_nodes, seed=seed,
        adjacency=("dense" if model_cfg.adjacency == "dense" else "sparse"))
    cfg = TrainerConfig(
        task="tile", rank_phi=rank_phi, steps=steps,
        ckpt_every=steps, log_every=log_every or max(steps // 4, 1),
        seed=seed, ckpt_dir=ckpt_dir, metrics_path=metrics_path,
        prefetch=prefetch, prefetch_device_put=prefetch_device_put,
        optim=AdamWConfig(lr=lr, warmup_steps=warmup_steps))
    trainer = CostModelTrainer(train_cfg, cfg, sampler, device=device)
    from_step = trainer.warm_start(warm_start_dir,
                                   reset_opt_step=reset_opt_step)
    history: list = []
    eval_fn = None
    if val_sampler is not None and eval_every:
        from repro_torch.core.evaluate import make_predict_fn
        predict = make_predict_fn(model_cfg)

        def eval_fn(model, step):
            v = tile_val_loss(model, model_cfg, val_sampler,
                              batches=val_batches, rank_phi=rank_phi,
                              predict_fn=predict)
            history.append((step, v))
            return {"val_loss": v}

    res = trainer.run(resume=False, eval_fn=eval_fn, eval_every=eval_every)
    return FineTuneResult(params=trainer.model, steps=res["step"],
                          from_step=from_step,
                          final_train_loss=res["loss"],
                          val_history=history)
