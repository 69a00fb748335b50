"""ray_tpu_torch.parallel — the train step, on one device or over a device
mesh, and in ``mesh`` the meshes, shardings and collectives."""

from .train_step import (Optimizer, TrainState, init_sharded_state,
                         make_eval_step, make_optimizer, make_train_step,
                         state_shardings)

__all__ = ["Optimizer", "TrainState", "make_optimizer", "state_shardings",
           "init_sharded_state", "make_train_step", "make_eval_step"]
