"""ray_tpu_torch.parallel — the train step (one card) and, in ``mesh``,
device meshes and the tensor-parallel all-reduce."""

from .train_step import (Optimizer, TrainState, init_sharded_state,
                         make_eval_step, make_optimizer, make_train_step)

__all__ = ["Optimizer", "TrainState", "make_optimizer", "init_sharded_state",
           "make_train_step", "make_eval_step"]
