"""The port's counterparts of the reference's ``slow`` learning gates
(tests/test_rllib.py, tests/test_rllib_conv_sac.py,
tests/test_rllib_impala.py, tests/test_rllib_offline.py): PPO and A2C on
CartPole, conv PPO on Catch, SAC, TD3 and DDPG on Pendulum, IMPALA on
CartPole, MARWIL against BC on a mixed corpus, and PPO on CartPole with
two learner actors (tests/test_learner_group.py), with the reference's
configs and thresholds, the runners actors of the port's runtime, updates
on the CPU.  Marked ``slow`` as the reference's are."""

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
    """One runtime of the port for this file: the drivers' runners and
    learners are its actors, each on one torch thread."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 << 20,
                       worker_env={"OMP_NUM_THREADS": "1"})
    yield
    ray_tpu_torch.shutdown()


def _best(algo, iters, stop_at, key="episode_return_mean"):
    best, res = -np.inf, None
    try:
        for _ in range(iters):
            res = algo.train()
            if np.isfinite(res[key]):
                best = max(best, res[key])
            if best >= stop_at:
                break
    finally:
        algo.stop()
    return best, res


@pytest.mark.slow
def test_ppo_learns_cartpole():
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=128)
            .training(lr=1e-3, num_epochs=8, num_minibatches=4,
                      entropy_coeff=0.01, model={"hidden": (64, 64)})
            .debugging(seed=0)
            .build(device="cpu"))
    best, _ = _best(algo, 30, 100.0)
    assert best >= 100.0, f"PPO failed to learn CartPole: best {best}"


@pytest.mark.slow
def test_a2c_learns_cartpole():
    from ray_tpu_torch.rllib import A2CConfig

    config = (A2CConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=128)
              .training(lr=1e-3, model={"hidden": (64, 64)})
              .debugging(seed=0))
    assert config.train["num_epochs"] == 1
    assert config.train["num_minibatches"] == 1
    best, _ = _best(config.build(device="cpu"), 40, 80.0)
    assert best >= 80.0, f"A2C failed to learn CartPole: best {best}"


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_ppo_conv_learns_catch():
    from ray_tpu_torch.rllib.ppo import PPOConfig

    algo = (PPOConfig()
            .environment("ray_tpu_torch.rllib.examples_env:Catch-v0")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(lr=3e-4,
                      model=dict(conv=True, filters=((16, 4, 2), (32, 3, 1)),
                                 conv_hidden=128),
                      entropy_coeff=0.01)
            .debugging(seed=0)
            .build(device="cpu"))
    best, _ = _best(algo, 80, 0.5)
    assert best >= 0.5, f"conv PPO failed to learn Catch: best={best}"


def _pendulum(config, name):
    config = (config.environment("Pendulum-v1")
              .env_runners(rollout_steps=200)
              .training(batch_size=128, train_iters=200,
                        replay=dict(capacity=50_000, learn_starts=600))
              .debugging(seed=0))
    best, res = _best(config.build(device="cpu"), 50, -750.0 + 1e-9)
    assert best > -750.0, f"{name} failed to learn Pendulum: best={best}"
    assert np.isfinite(res["critic_loss"])
    return res


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_sac_learns_pendulum():
    from ray_tpu_torch.rllib.sac import SACConfig

    res = _pendulum(SACConfig(), "SAC")
    assert np.isfinite(res["alpha"])


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_td3_learns_pendulum():
    from ray_tpu_torch.rllib import TD3Config

    res = _pendulum(TD3Config(), "TD3")
    # the delayed actor did step (loss left its 0 initialization)
    assert res["actor_loss"] != 0.0


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_ddpg_learns_pendulum():
    from ray_tpu_torch.rllib import DDPGConfig

    config = DDPGConfig()
    assert config.train["twin_q"] is False
    assert config.train["policy_delay"] == 1
    res = _pendulum(config, "DDPG")
    assert res["actor_loss"] != 0.0


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_impala_learns_cartpole_decoupled():
    """The reference's gate: IMPALA crosses 100 on CartPole, and the
    fragments it consumed were sampled under stale policy versions."""
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (IMPALAConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=64)
            .training(lr=5e-3, entropy_coeff=0.01, updates_per_iter=6)
            .debugging(seed=0)
            .build(device="cpu"))
    try:
        result = algo.train()
        for _ in range(39):
            result = algo.train()
            if result["episode_return_mean"] >= 100.0:
                break
        assert result["episode_return_mean"] >= 100.0, result
        assert max(algo.version_lags) >= 1, algo.version_lags
        assert result["mean_version_lag"] >= 0.5, result["mean_version_lag"]
    finally:
        algo.stop()


def _expert(obs):
    return int(obs[2] + 0.5 * obs[3] > 0)


def _random(obs):
    return int(np.random.default_rng(abs(int(obs[0] * 1e6)) % 2**31)
               .integers(0, 2))


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_marwil_beats_bc_on_mixed_data(tmp_path):
    """The reference's gate: on a transition-balanced expert + random
    corpus the advantage weighting (beta > 0) must not do worse than BC."""
    from ray_tpu_torch.rllib import MARWILConfig, collect_episodes

    path = str(tmp_path / "mixed.jsonl")
    expert_eps = collect_episodes("CartPole-v1", _expert, 4, path=path)
    n_expert = sum(len(e["rewards"]) for e in expert_eps)
    n_rand, seed = 0, 500
    while n_rand < n_expert:
        (ep,) = collect_episodes("CartPole-v1", _random, 1, path=path,
                                 seed=seed)
        n_rand += len(ep["rewards"])
        seed += 1

    def run(beta):
        algo = (MARWILConfig()
                .environment("CartPole-v1")
                .offline_data(path)
                .training(lr=3e-3, updates_per_iter=100, seed=1, beta=beta)
                .build(device="cpu"))
        for _ in range(5):
            algo.train()
        return algo.evaluate(num_episodes=5)

    marwil = run(1.0)
    bc = run(0.0)
    assert marwil > 60, marwil
    assert marwil >= bc * 0.8, (marwil, bc)


@pytest.mark.slow
def test_ppo_learns_cartpole_with_learner_actors():
    """The learning gate with num_learners=2: CartPole return clears 100
    (random policy ~20) with the update running in two learner actor
    processes, never in the driver."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=128)
            .learners(num_learners=2)
            .training(lr=1e-3, num_epochs=8, num_minibatches=4,
                      entropy_coeff=0.01, model={"hidden": (64, 64)})
            .debugging(seed=0)
            .build(device="cpu"))
    best, res = _best(algo, 30, 100.0)
    assert best >= 100.0, f"best return {best} < 100 within budget: {res}"
