"""Training meshes over torch.distributed (`mesh`): the counterpart of
`repro.sharding.mesh`. The reference's `partition` and `context`
(GSPMD sharding rules for the LM zoo's dry-run) wait for ROADMAP Queue 1
item 7."""
from repro_torch.sharding.mesh import DATA_AXIS, MODEL_AXIS, TrainMesh, \
    all_gather_stack, init_distributed, make_train_mesh, pick_backend, \
    spawn_ranks

__all__ = ["DATA_AXIS", "MODEL_AXIS", "TrainMesh", "all_gather_stack",
           "init_distributed", "make_train_mesh", "pick_backend",
           "spawn_ranks"]
