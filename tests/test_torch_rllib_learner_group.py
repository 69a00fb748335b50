"""The port's learner actors (ray_tpu_torch/rllib/learner_group.py) and
runner actors on the port's runtime, on the CPU.

Two learner actors form one ``torch.distributed`` group on gloo, each
with two CPU "devices" (dp=4 in all): the reference's
``tests/test_learner_group.py`` equality test on the port, for PPO's
``Learner`` and for ``ImpalaLearner``, each against the port's local
learner on one device from the same seed and batch, within the
reference's ``rtol=2e-4, atol=2e-5``; every rank must hold the same
params after the update.  Parity with JAX is a chain: the group equals
the port's local learner here, and the port's local learner equals JAX's
(``tests/test_torch_rllib_learner.py``,
``tests/test_torch_rllib_impala.py``).  Then the reference's IMPALA smoke
test with learner actors, and a runner actor's fragment against an
in-process ``EnvRunner``'s."""

import numpy as np
import pytest
import torch

import ray_tpu_torch

DP_TOL = dict(rtol=2e-4, atol=2e-5)


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
    """One runtime of the port for this file, its workers on one torch
    thread each."""
    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 << 20,
                       worker_env={"OMP_NUM_THREADS": "1"})
    yield
    ray_tpu_torch.shutdown()


def _ppo_rollout(rng, T, B):
    actions = rng.randint(0, 2, (T, B)).astype(np.float32)
    return {
        "obs": rng.randn(T, B, 4).astype(np.float32),
        "actions": actions,
        "logp": np.full((T, B), np.log(0.5), np.float32),
        "values": np.zeros((T, B), np.float32),
        "rewards": actions.copy(),
        "dones": np.zeros((T, B), np.float32),
        "last_values": np.zeros((B,), np.float32),
    }


def _impala_fragment(rng, T, B):
    """A fragment whose behaviour logp is off the policy's, so some
    importance weights clip, with episode ends inside it."""
    r = _ppo_rollout(rng, T, B)
    r["logp"] = (np.log(0.5) + 0.3 * rng.randn(T, B)).astype(np.float32)
    r["values"] = rng.randn(T, B).astype(np.float32)
    r["rewards"] = rng.randn(T, B).astype(np.float32)
    r["dones"] = (rng.rand(T, B) < 0.1).astype(np.float32)
    r["last_values"] = rng.randn(B).astype(np.float32)
    return r


@pytest.mark.parametrize("kind", ["ppo", "impala"])
def test_distributed_group_matches_local_update(kind):
    """2 learner processes x 2 devices (dp=4) == the single-device
    learner, same seed, same batch; rank 1's params equal rank 0's."""
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.learner import Learner
    from ray_tpu_torch.rllib.learner_group import DistributedLearnerGroup
    from ray_tpu_torch.rllib.models import build_model

    spec = dict(obs_dim=4, action_dim=2, hidden=(16,), continuous=False)
    rng = np.random.RandomState(3)
    if kind == "ppo":
        cls, cfg = Learner, {"lr": 1e-3, "num_epochs": 1,
                             "num_minibatches": 2}
        rollouts = [_ppo_rollout(rng, T=8, B=8)]
    else:
        cls = ImpalaLearner
        cfg = {"lr": 5e-3, "gamma": 0.97, "grad_clip": 40.0,
               "entropy_coeff": 0.01, "vtrace_c_clip": 0.9}
        rollouts = [_impala_fragment(rng, T=16, B=8) for _ in range(2)]

    local = cls(build_model(spec), cfg, seed=11, device="cpu")
    group = DistributedLearnerGroup(spec, cfg, num_learners=2, seed=11,
                                    learner_cls=cls, devices_per_learner=2,
                                    device="cpu")
    try:
        assert group.info["num_processes"] == 2
        assert group.info["num_devices"] == 4  # 2 procs x 2 devices
        assert group.info["backend"] == "gloo"
        for r in rollouts:
            m_local = local.update({k: v.copy() for k, v in r.items()})
            m_group = group.update(r)
            assert set(m_local) == set(m_group)
            for k in m_local:
                np.testing.assert_allclose(m_group[k], m_local[k], **DP_TOL,
                                           err_msg=k)
        w_local, w_group = local.get_weights(), group.get_weights()
        w_rank1 = ray_tpu_torch.get(group.workers[1].get_weights.remote(),
                                    timeout=60)
        for k in w_local:
            np.testing.assert_allclose(w_group[k], w_local[k], **DP_TOL,
                                       err_msg=k)
            np.testing.assert_array_equal(w_rank1[k], w_group[k], err_msg=k)
    finally:
        group.shutdown()


def test_impala_with_learner_actors_smoke():
    """IMPALA's async loop with a remote V-trace learner group: a couple of
    iterations run, metrics flow back, and the version-lag diagnostic is
    still tracked (the decoupling evidence)."""
    from ray_tpu_torch.rllib import IMPALAConfig

    # IMPALA updates on ONE fragment at a time, so the fragment's env axis
    # (num_envs_per_env_runner) must divide across the 2 learner ranks.
    algo = (IMPALAConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .learners(num_learners=2)
            .training(updates_per_iter=4)
            .build(device="cpu"))
    try:
        result = algo.train()
        assert result["training_iteration"] == 1
        assert "policy_loss" in result
        assert np.isfinite(result["mean_version_lag"])
    finally:
        algo.stop()


def test_runner_actor_samples_what_the_in_process_runner_samples():
    """The same EnvRunner as an actor (its policy on the CPU) and
    in-process, from the same seed and weights: two fragments equal, and
    the episode returns."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    spec = dict(obs_dim=4, action_dim=2, hidden=(16,))
    model = ActorCriticMLP(4, 2, (16,))
    weights = {k: v.numpy() for k, v in
               model.init(torch.Generator().manual_seed(0)).items()}
    local = EnvRunner("CartPole-v1", spec, num_envs=2, seed=7, device="cpu")
    actor = ray_tpu_torch.remote(EnvRunner).options(num_cpus=1).remote(
        "CartPole-v1", spec, num_envs=2, seed=7, device="cpu")
    try:
        ref = ray_tpu_torch.put(weights)
        for _ in range(2):
            want = local.sample(weights, rollout_len=32)
            got = ray_tpu_torch.get(actor.sample.remote(ref, 32), timeout=60)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (ray_tpu_torch.get(actor.episode_returns.remote(), timeout=60)
                == local.episode_returns())
    finally:
        ray_tpu_torch.kill(actor)
