"""The reference's tier-1 DQN learning gate (tests/test_rllib_dqn.py) on
the port, its runner in-process and its update on the CPU."""

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


def test_dqn_learns_cartpole():
    pytest.importorskip("gymnasium")
    from ray_tpu_torch.rllib.dqn import DQNConfig

    algo = (DQNConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_steps=400)
            .training(lr=1e-3, batch_size=64, train_iters=16,
                      target_update_tau=0.005, n_step=3,
                      replay=dict(capacity=50_000, learn_starts=1_000))
            .exploring(epsilon_start=1.0, epsilon_end=0.05,
                       epsilon_decay_steps=10_000)
            .debugging(seed=0)
            .build(device="cpu"))
    try:
        best = -np.inf
        for _ in range(90):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 60.0:
                break
        # untrained CartPole hovers near ~20 return; learning must clear it
        assert best >= 60.0, f"DQN failed to learn: best={best}"
        assert np.isfinite(result["loss"])
    finally:
        algo.stop()
