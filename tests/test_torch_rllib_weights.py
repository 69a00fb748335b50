"""``get_weights()`` of the port's learners and algorithms is a snapshot on
the CPU, as the reference's is (it reads immutable jax arrays): after one
update the blob handed out before it is unchanged, and it shares no
memory with the params the optimizer moves in place."""

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


def _rollout(T=8, B=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((T, B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.float32),
            "logp": np.full((T, B), np.log(0.5), np.float32),
            "values": rng.standard_normal((T, B)).astype(np.float32),
            "rewards": rng.standard_normal((T, B)).astype(np.float32),
            "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
            "last_values": rng.standard_normal(B).astype(np.float32)}


def _on_cpu(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _learner():
    from ray_tpu_torch.rllib import Learner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    lrn = Learner(ActorCriticMLP(4, 2, (8,)), {"lr": 1e-2}, device="cpu")
    return lrn, lrn.params, lambda: lrn.update(_rollout())


def _learner_group():
    from ray_tpu_torch.rllib import LearnerGroup
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    grp = LearnerGroup(ActorCriticMLP(4, 2, (8,)), {"lr": 1e-2},
                       num_learners=2, device="cpu")
    return grp, grp.learner.params, lambda: grp.update(_rollout())


def _ppo():
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, rollout_fragment_length=16)
            .training(lr=1e-2, num_epochs=1, num_minibatches=2,
                      model={"hidden": (8,)})
            .build(device="cpu"))
    return algo, algo.learner_group.learner.params, algo.train


def _dqn():
    from ray_tpu_torch.rllib import DQN, DQNConfig

    algo = DQN.learner_only(DQNConfig().training(model={"hidden": (8,)}),
                            4, 2, device="cpu")
    rng = np.random.default_rng(0)
    b = _on_cpu({"obs": rng.standard_normal((16, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 16).astype(np.int32),
                 "rewards": rng.standard_normal(16).astype(np.float32),
                 "next_obs": rng.standard_normal((16, 4)).astype(np.float32),
                 "discounts": np.full(16, 0.99, np.float32)})

    def step():
        algo.params, algo.target_params, algo.opt_state, _, _ = \
            algo._update(algo.params, algo.target_params, algo.opt_state, b)
    return algo, algo.params, step


def _sa_batch():
    rng = np.random.default_rng(0)
    return _on_cpu({"obs": rng.standard_normal((16, 3)).astype(np.float32),
                    "actions": rng.uniform(-1, 1, (16, 1)).astype(np.float32),
                    "rewards": rng.standard_normal(16).astype(np.float32),
                    "next_obs": rng.standard_normal((16, 3)).astype(
                        np.float32),
                    "dones": np.zeros(16, np.float32)})


def _sac():
    from ray_tpu_torch.rllib import SAC, SACConfig

    algo = SAC.learner_only(SACConfig().training(hidden=(8, 8)), 3, 1,
                            device="cpu")
    b = _sa_batch()

    def step():
        algo.state, algo.opt_state, _, _, _ = algo._update(
            algo.state, algo.opt_state, b, torch.Generator().manual_seed(0))
    return algo, algo.state["pi"], step


def _td3():
    from ray_tpu_torch.rllib import TD3, TD3Config

    algo = TD3.learner_only(TD3Config().training(hidden=(8, 8)), 3, 1,
                            device="cpu")
    b = _sa_batch()

    def step():
        algo.state, algo.opt_state, _, _ = algo._update(
            algo.state, algo.opt_state, b, torch.Generator().manual_seed(0),
            True)
    return algo, algo.state["pi"], step


@pytest.mark.parametrize("make", [_learner, _learner_group, _ppo, _dqn,
                                  _sac, _td3],
                         ids=["Learner", "LearnerGroup(num_learners=2)",
                              "PPO", "DQN", "SAC", "TD3"])
def test_get_weights_is_a_snapshot(make):
    owner, params, update = make()
    try:
        blob = owner.get_weights()
        kept = {k: v.copy() for k, v in blob.items()}
        for k, v in params.items():
            assert not np.shares_memory(blob[k], v.detach().numpy()), k
        update()
        live = owner.get_weights()
        assert any(not np.array_equal(live[k], kept[k]) for k in kept), \
            "the update moved no param: the test has no power"
        for k in kept:
            np.testing.assert_array_equal(blob[k], kept[k], err_msg=k)
    finally:
        if hasattr(owner, "stop"):
            owner.stop()
