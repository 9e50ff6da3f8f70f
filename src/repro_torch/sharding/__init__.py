"""Sharding for the port: training meshes over torch.distributed
(`mesh`, the counterpart of `repro.sharding.mesh`), the LM zoo's
partition rules (`partition`: param / optimizer / batch / cache specs,
DTensor placements) and the activation-sharding context (`context`:
`constrain` at the reference's points, the identity without a mapping).
"""
from repro_torch.sharding.context import activation_sharding, constrain, \
    constrain_batch_tree, dp_axes
from repro_torch.sharding.mesh import DATA_AXIS, MODEL_AXIS, TrainMesh, \
    all_gather_stack, init_distributed, make_train_mesh, pick_backend, \
    spawn_ranks
from repro_torch.sharding.partition import batch_specs, cache_specs, \
    opt_specs, param_specs

__all__ = ["DATA_AXIS", "MODEL_AXIS", "TrainMesh", "activation_sharding",
           "all_gather_stack", "batch_specs", "cache_specs", "constrain",
           "constrain_batch_tree", "dp_axes", "init_distributed",
           "make_train_mesh", "opt_specs", "param_specs", "pick_backend",
           "spawn_ranks"]
