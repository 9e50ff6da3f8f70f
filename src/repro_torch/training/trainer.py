"""Cost-model trainer, single device, in PyTorch.

Counterpart of `repro.training.trainer` on one device:
  * deterministic batch streams (seed, step): the sampler's `batch(step)`
    is pure, and the step's dropout generator is seeded anew from
    (seed + 1, step), so a run resumed from a checkpoint reproduces the
    uninterrupted one,
  * SIGTERM/SIGINT-safe: a final checkpoint is written on the way out,
  * periodic atomic checkpoints in the JAX package's format
    (`training.checkpoint`) + automatic resume from the latest, and
    `warm_start` from another run's checkpoint (either package's),
  * metrics streamed to JSONL with the reference's keys (`step`, `loss`,
    `lr`, `grad_norm`, `wall`, `eval/*`).

A step is the forward with dropout (`training=True`), `loss.backward()`
and the ported AdamW under `torch.no_grad()`, written into the model's
parameters and the moments in place (`training.optim.adamw_update_`,
bit for bit the pure `adamw_update`).
Batches are whatever the sampler yields: dense `GraphBatch`, packed
`SparseGraphBatch` or `SegmentedGraphBatch`, as numpy; each step moves
its batch to the trainer's device. With `TrainerConfig.prefetch > 0` the
sampler is wrapped in a `repro_torch.data.prefetch.Prefetcher`: a
background thread encodes that many batches ahead, and with
`prefetch_device_put` it also copies their graph arrays to the trainer's
device (pinned memory, a side stream); the step then takes them as they
are. The stream of batches, and so every loss, is the same as without.
The device is explicit (`"cuda"` by default); asking for the card
without one raises.

The aggregation kernels have no backward in either package, so the
trainer refuses `use_pallas_aggregate=True` on every layout (the kernel
wrappers also refuse inputs that require grad).

With `TrainerConfig.dp >= 1` the trainer runs the data-parallel step
of the reference's mesh (`repro.training.trainer`'s `_build_mesh_step`),
one rank a process: `sharding.make_train_mesh(dp, mp)` places the rank
in the grid (a process group of dp·mp ranks must exist: `torchrun`, or
`sharding.spawn_ranks`, which `launch/train.py` uses), every rank wraps
the sampler in the same `GlobalBatchSampler.for_mesh(sampler, dp)` and
trains on shard [data rank] of each global batch, with the dropout
generator of (seed + 1, step·dp + data rank). After `backward()` each
rank takes one reduction of its gradients over the data group: the mean
(one all_reduce of all leaves and the loss, a SUM then a division), or
with `compress_grads` the int8 error-feedback all-reduce
(`training.compression`), whose residuals stay on their rank. Every
rank then runs the same AdamW update on the same reduced gradients, so
the parameters stay bit-equal across ranks; dp=1 is bit-identical to
dp=0 (same batch, same generator, a mean over one rank is exact). Rank
0 alone writes checkpoints and metrics; the residuals are gathered into
`opt["ef"]` with a leading [dp] axis, the reference's layout, and a
checkpoint of another dp restores with them at zero. A stop signal on
any rank stops all of them after the same step (the flag rides on the
loss's reduction). At dp=0 `compress_grads` quantizes on the one device
(dense batches only, as in the reference).
"""
from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.core.losses import log_mse_loss, mse_loss, \
    pairwise_rank_loss
from repro_torch.core.model import CostModel, CostModelConfig, \
    batch_to_device, cost_model_apply, cost_model_init
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.compression import compressed_allreduce, \
    zeros_like_error
from repro_torch.training.optim import AdamWConfig, adamw_init, \
    adamw_update_, divide, tree_leaves, tree_map, tree_unflatten


@dataclass
class TrainerConfig:
    task: str = "tile"             # tile | fusion | fusion_mse | tile_mse
    rank_phi: str = "hinge"              # hinge | logistic (tile task)
    steps: int = 2000
    ckpt_every: int = 500
    log_every: int = 100
    keep_ckpts: int = 3
    seed: int = 0
    ckpt_dir: str = ""
    metrics_path: str = ""
    prefetch: int = 0                     # batches encoded ahead (0 = off)
    prefetch_device_put: bool = False     # also overlap host->device copies
    compress_grads: bool = False    # int8 + error feedback over the data axis
    data_axis: str = "data"
    # dp=0: one device, no process group; dp>=1: the rank's data-parallel
    # step over a (dp, mp) grid of ranks, params replicated over both axes
    dp: int = 0
    mp: int = 1
    optim: AdamWConfig = field(default_factory=AdamWConfig)


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    # a leaf the loss does not reach gets a zero gradient, as under jax.grad
    return torch.zeros_like(p) if p.grad is None else p.grad


class _RankShard:
    """The sampler of one rank: shard `d` of a `GlobalBatchSampler`."""

    def __init__(self, sampler, d: int):
        self.sampler, self.d = sampler, d

    def batch(self, step: int):
        return self.sampler.shard(step, self.d)


class CostModelTrainer:
    def __init__(self, model_cfg: CostModelConfig, cfg: TrainerConfig,
                 sampler, *, device: str | torch.device = "cuda"):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.step = 0
        self._stop = False
        self._halt = False
        self._metrics_f = None
        self._use_mesh = cfg.dp >= 1

        if cfg.dp < 0 or cfg.mp < 1:
            raise ValueError(f"dp must be >= 0 and mp >= 1, "
                             f"got dp={cfg.dp} mp={cfg.mp}")
        if model_cfg.precision != "f32":
            raise ValueError(
                f"training runs in f32, got precision="
                f"{model_cfg.precision!r} — train the f32 model and "
                "quantize afterwards (repro_torch.quant.quantize_params)")
        if self._use_mesh and model_cfg.adjacency == "segmented":
            raise ValueError(
                "segmented batches have no uniform leading axis to shard "
                "over the mesh — use adjacency='dense' or 'sparse' with "
                "TrainerConfig.dp")
        if (model_cfg.adjacency in ("sparse", "segmented")
                and cfg.compress_grads and not self._use_mesh):
            raise ValueError(
                "compress_grads=True needs a leading batch dim to shard "
                "and packed sparse batches have none; the mesh train "
                "step stacks per-device sub-batches with one — set "
                "TrainerConfig.dp >= 1 (compress_grads composes with "
                "adjacency='sparse' there) or use adjacency='dense'")
        if model_cfg.use_pallas_aggregate:
            raise ValueError(
                "use_pallas_aggregate routes the GNN through the "
                "graph_aggregate / segment_aggregate kernels, which have no "
                "backward in either package (the TPU kernels have no VJP "
                "either) — they are inference-only; train with "
                "use_pallas_aggregate=False and serve with it on")
        if (model_cfg.adjacency in ("sparse", "segmented")
                and model_cfg.gnn == "gat" and not model_cfg.directed):
            raise ValueError(
                "undirected GAT is dense-only (DESIGN.md §4) — use "
                "adjacency='dense'")

        self.mesh = None
        self.sampler = sampler
        self._rank_sampler = sampler
        if self._use_mesh:
            from repro_torch.data.sampler import GlobalBatchSampler
            from repro_torch.sharding.mesh import DATA_AXIS, \
                make_train_mesh
            if cfg.data_axis != DATA_AXIS:
                raise ValueError(
                    f"the mesh train step uses axis {DATA_AXIS!r}; got "
                    f"data_axis={cfg.data_axis!r}")
            if isinstance(sampler, GlobalBatchSampler):
                if sampler.num_shards != cfg.dp:
                    raise ValueError(
                        f"GlobalBatchSampler has {sampler.num_shards} "
                        f"shards but dp={cfg.dp}")
            else:
                sampler = GlobalBatchSampler.for_mesh(sampler, cfg.dp)
            self.mesh = make_train_mesh(cfg.dp, cfg.mp, device=device)
            self.sampler = sampler
            self._rank_sampler = _RankShard(sampler, self.mesh.data_rank)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.model: CostModel = cost_model_init(
            torch.Generator().manual_seed(cfg.seed), model_cfg,
            device=self.device).requires_grad_(True)
        self.params = self.model.tree()       # leaves: the model's Parameters
        self.opt_state = adamw_init(self.params)
        if cfg.compress_grads:
            # this rank's residuals; checkpoints stack them to [dp, ...]
            self.opt_state["ef"] = zeros_like_error(self.params)

    @property
    def _group(self):
        return self.mesh.data_group if self._use_mesh else None

    @property
    def _rank0(self) -> bool:
        return not self._use_mesh or self.mesh.rank == 0

    @property
    def _halted(self) -> bool:
        # on the mesh the ranks stop together, on the flag they agreed on
        return self._halt if self._use_mesh else self._stop

    # ------------------------------------------------------------------
    def loss(self, b, *, generator: torch.Generator | None = None,
             training: bool = False) -> torch.Tensor:
        """The task's loss on one sampler batch (`TileBatch` or
        `FusionBatch`, numpy), on the trainer's device. Dropout runs only
        with `training=True` and a generator."""
        dev = self.device
        graphs = batch_to_device(b.graphs, dev)
        targets = torch.from_numpy(np.asarray(b.targets)).to(dev)
        valid = torch.from_numpy(np.asarray(b.valid)).to(dev)
        preds = cost_model_apply(self.params, self.model_cfg, graphs,
                                 generator=generator, training=training)
        task = self.cfg.task
        if task == "tile":
            group_ids = getattr(b, "group_ids",
                                np.zeros_like(b.targets, np.int32))
            return pairwise_rank_loss(
                preds, targets, torch.from_numpy(np.asarray(group_ids)).to(
                    dev), valid, phi=self.cfg.rank_phi)
        if task == "fusion":
            return log_mse_loss(preds, targets, valid)
        if task == "fusion_mse":
            return mse_loss(preds, targets, valid)
        if task == "tile_mse":
            # ablation row 'MSE loss (not rank)': absolute (log) runtimes
            return log_mse_loss(preds, targets, valid)
        raise ValueError(f"unknown task {task!r}")

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout generator of `step`: a pure function of
        (seed + 1, step), seeded anew for every step; on the mesh, of
        (seed + 1, step·dp + data rank), the reference's ladder, which
        at dp=1 is the single-device generator."""
        key = step
        if self._use_mesh:
            key = step * self.cfg.dp + self.mesh.data_rank
        seed = np.random.SeedSequence([self.cfg.seed + 1, key]) \
            .generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _reduce(self, grads, loss: torch.Tensor):
        """The step's one reduction over the data group: returns (the
        mean gradients, or the int8 error-feedback all-reduce's, the mean
        loss, whether any rank was asked to stop). Off the mesh it is the
        identity, but for the compressed path's quantization."""
        group = self._group
        if self.cfg.compress_grads:
            grads, self.opt_state["ef"] = compressed_allreduce(
                grads, self.opt_state["ef"], group)
        if group is None:
            return grads, loss, self._stop
        n = dist.get_world_size(group)
        flag = torch.tensor([float(self._stop)], device=self.device)
        leaves = [] if self.cfg.compress_grads else tree_leaves(grads)
        flat = torch.cat([x.reshape(-1) for x in leaves]
                         + [loss.reshape(1), flag])
        dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
        stop = bool(flat[-1] > 0)
        flat = divide(flat[:-1], n)
        if leaves:
            parts, start = [], 0
            for x in leaves:
                parts.append(flat[start:start + x.numel()].view(x.shape))
                start += x.numel()
            grads = tree_unflatten(grads, parts)
        return grads, flat[-1], stop

    def _train_step(self, b) -> dict:
        loss = self.loss(b, generator=self.step_generator(self.step),
                         training=True)
        loss.backward()
        with torch.no_grad():
            grads = tree_map(_grad_of, self.params)
            grads, loss, self._halt = self._reduce(grads, loss.detach())
            opt = {k: v for k, v in self.opt_state.items() if k != "ef"}
            _, opt, stats = adamw_update_(self.params, grads, opt,
                                          self.cfg.optim)
            self.opt_state.update(opt)
            for p in tree_leaves(self.params):
                p.grad = None
        stats["loss"] = loss
        return stats

    def _load_params(self, params) -> None:
        with torch.no_grad():
            for p, v in zip(tree_leaves(self.params), tree_leaves(params)):
                p.copy_(v)

    # ------------------------------------------------------------------
    def _install_signal_handlers(self) -> dict:
        """Route SIGTERM/SIGINT to a stop flag; returns the handlers they
        replace (none off the main thread, where signals cannot be set)."""
        def handler(signum, frame):
            self._stop = True
        old = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old[sig] = signal.signal(sig, handler)
        except ValueError:
            pass   # not on main thread (e.g. under pytest plugins)
        return old

    def _log(self, record: dict):
        if self.cfg.metrics_path and self._rank0:
            if self._metrics_f is None:
                os.makedirs(os.path.dirname(self.cfg.metrics_path) or ".",
                            exist_ok=True)
                self._metrics_f = open(self.cfg.metrics_path, "a")
            self._metrics_f.write(json.dumps(record) + "\n")
            self._metrics_f.flush()

    def save(self):
        """Write a checkpoint (rank 0 alone; on the mesh every rank must
        call it, to gather the error-feedback residuals)."""
        if not self.cfg.ckpt_dir:
            return
        opt = self.opt_state
        if self._use_mesh and "ef" in opt:
            from repro_torch.sharding.mesh import all_gather_stack
            opt = {**opt, "ef": tree_map(
                lambda e: all_gather_stack(e, self._group), opt["ef"])}
        if not self._rank0:
            return
        state = {"params": self.params, "opt": opt}
        ckpt_lib.save_checkpoint(
            self.cfg.ckpt_dir, self.step, state,
            meta={"model_cfg": self.model_cfg.to_dict(),
                  "task": self.cfg.task},
            keep=self.cfg.keep_ckpts)

    def maybe_resume(self) -> bool:
        if not self.cfg.ckpt_dir:
            return False
        if ckpt_lib.latest_step(self.cfg.ckpt_dir) is None:
            return False
        opt = self.opt_state
        if self._use_mesh and "ef" in opt:
            opt = {**opt, "ef": tree_map(
                lambda e: e.new_zeros((self.cfg.dp,) + tuple(e.shape)),
                opt["ef"])}
        try:
            state, step, _ = ckpt_lib.restore_checkpoint(
                self.cfg.ckpt_dir, {"params": self.params, "opt": opt})
        except ValueError:
            if "ef" not in opt:
                raise
            # a checkpoint of another dp layout: the residuals are
            # per-rank quantization carry, not model state, so they
            # restart at zero and everything else restores bit-exactly
            state, step, _ = ckpt_lib.restore_checkpoint(
                self.cfg.ckpt_dir,
                {"params": self.params,
                 "opt": {k: v for k, v in opt.items() if k != "ef"}})
            state["opt"]["ef"] = tree_map(torch.zeros_like,
                                          self.opt_state["ef"])
        else:
            if self._use_mesh and "ef" in opt:
                d = self.mesh.data_rank
                state["opt"]["ef"] = tree_map(lambda e: e[d].clone(),
                                              state["opt"]["ef"])
        self._load_params(state["params"])
        self.opt_state = state["opt"]
        self.step = step
        return True

    def warm_start(self, ckpt_dir: str, *, step: int | None = None,
                   restore_opt: bool = True,
                   reset_opt_step: bool = True) -> int:
        """Initialize from ANOTHER run's checkpoint (either package's),
        keeping this run fresh — the flywheel fine-tune path.

        Unlike `maybe_resume` (which continues the same run: `self.step`
        jumps to the checkpoint step), `warm_start` copies the
        checkpoint's params — and, with `restore_opt`, the AdamW moments —
        but leaves ``self.step`` at 0, so the full `cfg.steps` run.
        Error-feedback residuals are never imported: they are per-rank
        quantization carry, not model state.
        `reset_opt_step=True` also zeroes the optimizer's step counter,
        restarting the `AdamWConfig.warmup_steps` LR warmup;
        `reset_opt_step=False` keeps it, so the schedule continues.

        Returns the checkpoint step warm-started from. `run`'s default
        ``resume=True`` still prefers a checkpoint in THIS run's
        `cfg.ckpt_dir` if one exists.
        """
        pick = ckpt_lib.latest_step(ckpt_dir) if step is None else step
        if pick is None:
            raise FileNotFoundError(
                f"no checkpoint to warm-start from in {ckpt_dir!r}")
        like = {"params": self.params}
        if restore_opt:
            like["opt"] = {k: v for k, v in self.opt_state.items()
                           if k != "ef"}
        state, ck_step, _ = ckpt_lib.restore_checkpoint(ckpt_dir, like,
                                                        step=pick)
        self._load_params(state["params"])
        if restore_opt:
            opt = dict(state["opt"])
            if reset_opt_step:
                opt["step"] = torch.zeros_like(opt["step"])
            if "ef" in self.opt_state:
                opt["ef"] = self.opt_state["ef"]
            self.opt_state = opt
        self.step = 0
        return ck_step

    # ------------------------------------------------------------------
    def run(self, steps: int | None = None, *, resume: bool = True,
            eval_fn: Callable[[CostModel, int], dict] | None = None,
            eval_every: int = 0) -> dict:
        """Train up to step `steps` (default `cfg.steps`). `eval_fn(model,
        step)` runs every `eval_every` steps; its dict is logged under
        `eval/`. Returns {"step", "loss" (of the last logged step),
        "wall", "interrupted"}."""
        cfg = self.cfg
        total = steps if steps is not None else cfg.steps
        if resume:
            self.maybe_resume()
        old = self._install_signal_handlers()
        sampler = self._rank_sampler
        if cfg.prefetch:
            from repro_torch.data.prefetch import Prefetcher
            sampler = Prefetcher(
                self._rank_sampler, depth=cfg.prefetch,
                start_step=self.step,
                device=self.device if cfg.prefetch_device_put else None)
        try:
            return self._run_loop(sampler, total, eval_fn, eval_every)
        finally:
            if sampler is not self._rank_sampler:
                sampler.close()
            for sig, h in old.items():
                signal.signal(sig, h)

    def _run_loop(self, sampler, total: int, eval_fn, eval_every) -> dict:
        cfg = self.cfg
        t0 = time.time()
        last_loss = float("nan")
        while self.step < total and not self._halted:
            stats = self._train_step(sampler.batch(self.step))
            self.step += 1
            if self.step % cfg.log_every == 0 or self.step == total:
                last_loss = float(stats["loss"])
                self._log({"step": self.step, "loss": last_loss,
                           "lr": float(stats["lr"]),
                           "grad_norm": float(stats["grad_norm"]),
                           "wall": time.time() - t0})
            if cfg.ckpt_every and self.step % cfg.ckpt_every == 0:
                self.save()
            if eval_fn and eval_every and self.step % eval_every == 0:
                ev = eval_fn(self.model, self.step)
                self._log({"step": self.step, **{f"eval/{k}": v
                                                 for k, v in ev.items()}})
        self.save()
        if self._metrics_f:
            self._metrics_f.close()
            self._metrics_f = None
        return {"step": self.step, "loss": last_loss,
                "wall": time.time() - t0, "interrupted": self._halted}
