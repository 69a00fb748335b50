"""ray_tpu_torch.parallel — mesh construction, sharding, the train step on
one device or over a device mesh, the pipeline (GPipe and interleaved
stages over the pp axis), and the dp-manual step (ZeRO-sharded
update, int8 block-quantized gradient collectives); in ``mesh`` the
meshes, shardings and collectives."""

from .mesh import AXIS_ORDER, MeshSpec, make_mesh, named_sharding
from .train_step import (Optimizer, TrainState, init_sharded_state,
                         make_eval_step, make_optimizer, make_train_step,
                         state_shardings)
from .pipeline import (init_pp_state, make_pp_train_step, merge_layers,
                       partition_layers)
from .zero import OptimizerSpec, init_zero_state, make_dp_train_step

__all__ = ["MeshSpec", "make_mesh", "named_sharding", "AXIS_ORDER",
           "Optimizer", "TrainState", "make_optimizer", "init_sharded_state",
           "make_train_step", "make_eval_step", "state_shardings",
           "OptimizerSpec", "init_zero_state", "make_dp_train_step",
           "init_pp_state", "make_pp_train_step", "partition_layers",
           "merge_layers"]
