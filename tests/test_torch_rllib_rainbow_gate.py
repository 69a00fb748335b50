"""The reference's tier-1 Rainbow learning gate
(tests/test_rllib_rainbow.py) on the port, in-process on the CPU."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: under the suite's parallel
    workers torch's threads oversubscribe the cores.  No tolerance here
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def runtime():
    """One runtime of the port for this file: the drivers' runners,
    workers and shards are its actors, each on one torch thread."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 << 20,
                       worker_env={"OMP_NUM_THREADS": "1"})
    yield
    ray_tpu_torch.shutdown()


def test_rainbow_learns_bandit():
    from ray_tpu_torch.rllib import RainbowConfig

    algo = (RainbowConfig()
            .environment("ray_tpu_torch.rllib.examples_env:Bandit-v0")
            .env_runners(num_env_runners=1, rollout_steps=128)
            .training(lr=5e-3, batch_size=64, train_iters=8, n_step=1,
                      model=dict(hidden=(32,), num_atoms=21,
                                 v_min=-1.0, v_max=9.0),
                      replay=dict(learn_starts=64, capacity=4096))
            .exploring(epsilon_decay_steps=400)
            .debugging(seed=0)
            .build(device="cpu"))
    best = -np.inf
    result = None
    try:
        for _ in range(25):
            result = algo.train()
            if np.isfinite(result["episode_return_mean"]):
                best = max(best, result["episode_return_mean"])
            if best >= 6.5:
                break
        assert best >= 6.5, result
    finally:
        algo.stop()
