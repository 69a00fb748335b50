"""The port's EnvRunner and PPO driver (ray_tpu_torch/rllib/env_runner.py,
ppo.py) on the CPU: the reference's rollout test, JAX's model on the port's
rollouts, a short ``PPO.train()`` with its runners as actors of the port's
runtime, learner actors at ``num_learners=1`` and what still raises."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


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


# ------------------------------------------------------------- runners

def test_env_runner_rollout_shapes():
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    runner = EnvRunner("CartPole-v1",
                       dict(obs_dim=4, action_dim=2, hidden=(16,)),
                       num_envs=2, seed=0, device="cpu")
    model = ActorCriticMLP(obs_dim=4, action_dim=2, hidden=(16,))
    params = {k: v.numpy() for k, v in
              model.init(torch.Generator().manual_seed(0)).items()}
    batch = runner.sample(params, rollout_len=16)
    assert batch["obs"].shape == (16, 2, 4)
    assert batch["actions"].shape == (16, 2)
    assert batch["last_values"].shape == (2,)
    assert batch["dones"].max() <= 1.0


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["cartpole", "pendulum"])
def test_jax_model_on_the_port_rollout(continuous):
    """JAX's apply and log_prob on the port's obs and actions give the
    port's values and logp (the actions are torch's draws)."""
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    env = "Pendulum-v1" if continuous else "CartPole-v1"
    obs_dim = 3 if continuous else 4
    action_dim = 1 if continuous else 2
    jm = JaxMLP(obs_dim, action_dim, (32, 32), continuous=continuous)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    runner = EnvRunner(env, dict(obs_dim=obs_dim, action_dim=action_dim,
                                 hidden=(32, 32), continuous=continuous),
                       num_envs=2, seed=3, device="cpu")
    weights = {k: np.asarray(v) for k, v in jp.items()}
    b = runner.sample(weights, rollout_len=24)
    T, N = 24, 2
    obs = jnp.asarray(b["obs"].reshape(T * N, obs_dim))
    acts = jnp.asarray(b["actions"].reshape(T * N, *b["actions"].shape[2:]))
    pi, v = jax.jit(jm.apply)(jp, obs)
    np.testing.assert_allclose(b["values"].reshape(-1), np.asarray(v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b["logp"].reshape(-1),
                               np.asarray(jm.log_prob(pi, acts)),
                               rtol=1e-5, atol=1e-5)
    _, last = jm.apply(jp, jnp.asarray(runner.obs, jnp.float32))
    np.testing.assert_allclose(b["last_values"], np.asarray(last),
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- drivers

RESULT_KEYS = {"training_iteration", "episode_return_mean",
               "episodes_this_iter", "num_env_steps_sampled",
               "time_this_iter_s", "policy_loss", "vf_loss", "entropy",
               "kl"}


def test_ppo_train_smoke():
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(num_epochs=2, num_minibatches=2,
                      model={"hidden": (16, 16)})
            .debugging(seed=0)
            .build(device="cpu"))
    try:
        for i in range(2):
            res = algo.train()
        assert set(res) == RESULT_KEYS
        assert res["training_iteration"] == 2
        assert res["num_env_steps_sampled"] == 2 * 32 * 2 * 2
        for k in ("policy_loss", "vf_loss", "entropy", "kl"):
            assert np.isfinite(res[k]), (k, res)
        assert res["episodes_this_iter"] > 0
        assert np.isfinite(res["episode_return_mean"])
    finally:
        algo.stop()


def test_runtime_parts_raise_not_implemented():
    """Only the Tune trainable raises now: ``num_learners=1`` builds one
    learner actor (gloo on the CPU), and the external-env mode is ported
    (tests/test_torch_rllib_external.py)."""
    from ray_tpu_torch.rllib import PPO, PPOConfig
    from ray_tpu_torch.rllib.learner_group import DistributedLearnerGroup

    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, rollout_fragment_length=16)
            .learners(num_learners=1).build(device="cpu"))
    try:
        assert isinstance(algo.learner_group, DistributedLearnerGroup)
        assert algo.learner_group.info["num_processes"] == 1
        assert algo.learner_group.info["backend"] == "gloo"
    finally:
        algo.stop()
    cfg = PPOConfig().external(port=9900)
    assert cfg.external_port == 9900 and cfg.external_fragment_len == 64
    with pytest.raises(NotImplementedError, match="A4"):
        PPO.as_tune_trainable(lambda c: c)
