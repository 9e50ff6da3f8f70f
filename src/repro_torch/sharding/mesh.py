"""Training meshes for the cost-model trainer, over torch.distributed.

Counterpart of `repro.sharding.mesh`. The reference lays a (dp, mp) grid
of devices out with axes ("data", "model") inside one process; here each
grid point is a process (a rank) with its own device, and
`make_train_mesh` gives every rank its place in the grid:

  rank = data_rank · mp + model_rank,

the `torch.distributed` subgroup of the ranks that share its model rank
(the data axis: gradients are averaged over it), and its device. As in
the reference the model axis exists at mp = 1 too, and the cost model's
parameters are replicated over both axes: ranks that differ only in
model rank compute the same thing.

The ranks come from `torchrun` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`/`MASTER_PORT` in the environment; `init_distributed()`
reads them) or from `spawn_ranks`, which starts them itself with the
`spawn` start method (CUDA forbids `fork` once it is initialised) and a
`file://` store in a temporary directory. The backend (`pick_backend`):
NCCL when every rank of a host has a card of its own, gloo with the
tensors left on the card when the ranks outnumber the cards (NCCL
refuses two ranks on one device), gloo on the CPU.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def pick_backend(device: str | torch.device, ranks_per_host: int) -> str:
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if ranks_per_host <= torch.cuda.device_count() \
        else "gloo"


def rank_device(device: str | torch.device, local_rank: int
                ) -> torch.device:
    """The device of the rank with index `local_rank` on its host: the
    CPU, or card local_rank mod the host's card count."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def init_distributed(device: str | torch.device = "cuda", *,
                     rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None) -> str:
    """Join the default process group and return its backend. With no
    `rank` it reads `torchrun`'s environment (`RANK`, `WORLD_SIZE`,
    `init_method="env://"`). Asking for the card without one raises."""
    resolve_device(device)
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError(
                "init_distributed: no rank given and RANK/WORLD_SIZE are "
                "not set; launch under torchrun or pass rank, world_size "
                "and init_method")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = pick_backend(device, per_host)
    dev = rank_device(device, _local_rank(rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


@dataclass(frozen=True)
class TrainMesh:
    """One rank's place in a (dp, mp) training grid."""
    dp: int
    mp: int
    rank: int
    data_rank: int
    model_rank: int
    data_group: object          # the ProcessGroup over the data axis
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}


def make_train_mesh(dp: int, mp: int = 1, *,
                    device: str | torch.device = "cuda") -> TrainMesh:
    """This rank's place in a ``(dp, mp)`` grid over the default process
    group, which must hold exactly ``dp * mp`` ranks. Every rank must
    call it (it creates the data-axis subgroups collectively).

    Raises ValueError when the group is missing or of another size; the
    message names the fix."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} mp={mp}")
    need = dp * mp
    launch = (f"start {need} ranks with `torchrun --nproc-per-node {need}`"
              f" or `python -m repro_torch.launch.train cost-model --dp "
              f"{dp} --mp {mp}` (which spawns them), or call "
              "repro_torch.sharding.init_distributed in each")
    if not dist.is_initialized():
        raise ValueError(f"mesh dp={dp} x mp={mp} needs a process group of "
                         f"{need} ranks and none is initialised: {launch}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh dp={dp} x mp={mp} needs {need} ranks but "
                         f"the process group has {world}: {launch}")
    rank = dist.get_rank()
    data_rank, model_rank = divmod(rank, mp)
    groups = [dist.new_group([d * mp + m for d in range(dp)])
              for m in range(mp)]
    return TrainMesh(dp=dp, mp=mp, rank=rank, data_rank=data_rank,
                     model_rank=model_rank, data_group=groups[model_rank],
                     device=rank_device(device, _local_rank(rank)))


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """[group size, *t.shape]: every rank's `t`, in rank order. gloo
    gathers card tensors through host copies (it reduces them on the card
    but gathers only host tensors)."""
    n = dist.get_world_size(group)
    host = dist.get_backend(group) != "nccl"
    src = t.detach().cpu() if host else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _rank_main(rank: int, fn, args: tuple, world_size: int,
               init_method: str, device: str) -> None:
    init_distributed(device, rank=rank, world_size=world_size,
                     init_method=init_method)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, args: tuple, world_size: int, *,
                device: str | torch.device = "cuda") -> None:
    """Run `fn(*args)` in `world_size` new processes (start method
    `spawn`), each a rank of one process group joined through a
    `file://` store in a temporary directory; returns when all have
    ended, and raises if one raised. `fn` must be importable by name
    (a module-level function) and `args` picklable; a rank finds its
    place with `make_train_mesh` and its rank with
    `torch.distributed.get_rank()`."""
    resolve_device(device)
    store = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=True, start_method="spawn",
            args=(fn, args, world_size,
                  "file://" + os.path.join(store, "store"), str(device)))
    finally:
        shutil.rmtree(store, ignore_errors=True)
