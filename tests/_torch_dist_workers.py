"""Rank functions for the port's multi-process tests.

`repro_torch.sharding.spawn_ranks` starts each rank with the `spawn`
start method, which imports the function by name in a fresh process:
these live here, beside the tests, and import torch and `repro_torch`
only (not JAX, whose import would cost every rank seconds). Each writes
what it computed under `out`, one file a rank; the tests compare.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist

MESH_MODEL = dict(hidden_dim=16, gnn_layers=1, transformer_layers=1,
                  dropout=0.0)


def tile_data():
    """The records and normalizer of tests/test_mesh_training.py, from
    the port's copies of the generators (the same records)."""
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.synthetic import random_kernel
    from repro_torch.data.tile_dataset import build_tile_records, \
        fit_tile_normalizer
    kernels = [random_kernel(n, seed=i)
               for i, n in enumerate((10, 14, 18, 12, 16, 20))]
    recs = build_tile_records(kernels, TPUSimulator(),
                              max_configs_per_kernel=8)
    return recs, fit_tile_normalizer(recs)


def tile_sampler(recs, norm, adjacency):
    from repro_torch.data.sampler import TileBatchSampler
    return TileBatchSampler(recs, norm, seed=3, adjacency=adjacency,
                            kernels_per_batch=2, configs_per_kernel=4)


def mesh_trainer(adjacency, dp, *, model_kw=None, **tc_kw):
    from repro_torch.core.model import CostModelConfig
    from repro_torch.training.trainer import CostModelTrainer, \
        TrainerConfig
    recs, norm = tile_data()
    mcfg = CostModelConfig(adjacency=adjacency,
                           **dict(MESH_MODEL, **(model_kw or {})))
    tc_kw.setdefault("ckpt_every", 0)
    tc = TrainerConfig(task="tile", steps=3, log_every=100, seed=0, dp=dp,
                       **tc_kw)
    return CostModelTrainer(mcfg, tc, tile_sampler(recs, norm, adjacency),
                            device="cpu")


class _StopAt:
    """A sampler view that raises the trainer's stop flag (as SIGTERM
    does) when it hands out step `at`."""

    def __init__(self, inner, trainer, at):
        self.inner, self.trainer, self.at = inner, trainer, at

    def batch(self, step):
        if step == self.at:
            self.trainer._stop = True
        return self.inner.batch(step)


def mesh_train(out, adjacency, dp, mp=1, compress=False, init_ckpt="",
               steps=3, stop_rank=None, stop_at=None):
    """Train `steps` steps on this rank (params from the JAX package's
    checkpoint `init_ckpt` when given); write rank<r>.npz (every param
    leaf, in tree order) and, from rank 0, result.json and the
    checkpoint in out/ckpt."""
    from repro_torch.training.optim import tree_leaves
    torch.set_num_threads(1)
    rank = dist.get_rank()
    tr = mesh_trainer(adjacency, dp, mp=mp, compress_grads=compress,
                      ckpt_dir=os.path.join(out, "ckpt"))
    if init_ckpt:
        tr.warm_start(init_ckpt, restore_opt=False)
    if rank == stop_rank:
        tr._rank_sampler = _StopAt(tr._rank_sampler, tr, stop_at)
    res = tr.run(steps, resume=False)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             *[x.detach().numpy() for x in tree_leaves(tr.params)])
    with open(os.path.join(out, f"result{rank}.json"), "w") as f:
        json.dump({**res, "data_rank": tr.mesh.data_rank,
                   "model_rank": tr.mesh.model_rank,
                   "device": str(tr.device)}, f)


def compress_ranks(out, inputs):
    """`compressed_allreduce` of this rank's trees from `inputs` (an npz
    with g<rank>_<leaf> and e<rank>_<leaf>) over the whole group."""
    from repro_torch.training.compression import compressed_allreduce
    rank = dist.get_rank()
    z = np.load(inputs)
    names = sorted(k[len(f"g{rank}_"):] for k in z.files
                   if k.startswith(f"g{rank}_"))
    g = {n: torch.from_numpy(z[f"g{rank}_{n}"]) for n in names}
    e = {n: torch.from_numpy(z[f"e{rank}_{n}"]) for n in names}
    red, err = compressed_allreduce(g, e, group=dist.group.WORLD)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{f"red_{n}": red[n].numpy() for n in names},
             **{f"err_{n}": err[n].numpy() for n in names})


def pipeline_ranks(out, inputs):
    """`pipeline_apply` of tanh(x @ W) layers from `inputs` (Ws [L, D,
    D], x [M, mb, D]) over the whole group, one stage a rank."""
    from repro_torch.training.pipeline import pipeline_apply, \
        pipeline_stage_split
    torch.set_num_threads(1)
    z = np.load(inputs)
    Ws, x = torch.from_numpy(z["Ws"]), torch.from_numpy(z["x"])

    def stage_fn(ws, h):
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    y = pipeline_apply(stage_fn, pipeline_stage_split(
        Ws, dist.get_world_size()), x)
    np.save(os.path.join(out, f"rank{dist.get_rank()}.npy"), y.numpy())
