"""The port's multi-agent pieces (ray_tpu_torch/rllib/multi_agent.py)
against the JAX package's (ray_tpu/rllib/multi_agent.py) on the CPU:
RockPaperScissors' steps equal, ``MultiAgentEnvRunner``'s per-policy
batches equal JAX's with JAX's draws fed in (``models._gumbel``), and the
reference's two-policy ``MultiAgentPPO`` test with the runners as
actors of the port's runtime."""

import numpy as np
import pytest
import torch

import jax


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


def test_multi_agent_env_contract():
    """The reference's test on the port's env."""
    from ray_tpu_torch.rllib import RockPaperScissors

    env = RockPaperScissors(episode_len=3)
    obs, _ = env.reset(seed=0)
    assert set(obs) == {"player_0", "player_1"}
    for t in range(3):
        obs, rew, term, trunc, _ = env.step({"player_0": 0, "player_1": 1})
        assert rew["player_0"] == -1.0 and rew["player_1"] == 1.0
        assert term["__all__"] == (t == 2)
    assert obs["player_0"][1] == 1.0  # the opponent played paper (1)


def test_rock_paper_scissors_steps_equal_the_reference():
    from ray_tpu.rllib import RockPaperScissors as Ref
    from ray_tpu_torch.rllib import RockPaperScissors

    a, b = Ref(episode_len=5), RockPaperScissors(episode_len=5)
    ra, rb = a.reset(seed=1), b.reset(seed=1)
    moves = np.random.default_rng(0).integers(0, 3, (12, 2))
    for m0, m1 in moves:
        act = {"player_0": int(m0), "player_1": int(m1)}
        ra, rb = a.step(act), b.step(act)
        for x, y in zip(ra, rb):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(np.asarray(y[k]),
                                              np.asarray(x[k]))
        if ra[2]["__all__"]:
            ra, rb = a.reset(), b.reset()
            for k in ra[0]:
                np.testing.assert_array_equal(rb[0][k], ra[0][k])
    assert a.observation_size == b.observation_size == 4
    assert a.num_actions == b.num_actions == 3


def jax_draws(seed, calls, steps_per_call):
    """The gumbel noise JAX's runner draws, call by call: its key is
    reseeded from (seed << 20) ^ calls and split once per agent step."""
    out = []
    for call in range(1, calls + 1):
        key = jax.random.PRNGKey((seed << 20) ^ call)
        for _ in range(steps_per_call):
            key, sub = jax.random.split(key)
            out.append(torch.from_numpy(np.array(
                jax.random.gumbel(sub, (1, 3)))))
    return out


@pytest.mark.parametrize("shared", [False, True],
                         ids=["policy_per_agent", "shared_policy"])
def test_runner_batches_equal_jax(shared, monkeypatch):
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu.rllib.multi_agent import MultiAgentEnvRunner as JaxRunner
    from ray_tpu_torch.rllib import RockPaperScissors
    from ray_tpu_torch.rllib import models as pmodels
    from ray_tpu_torch.rllib.multi_agent import MultiAgentEnvRunner

    agents = RockPaperScissors.possible_agents
    mapping = {a: ("shared" if shared else a) for a in agents}
    pids = sorted(set(mapping.values()))
    spec = dict(obs_dim=4, action_dim=3, hidden=(16,), continuous=False)
    specs = {pid: dict(spec) for pid in pids}
    weights = {}
    for i, pid in enumerate(pids):
        p = JaxMLP(4, 3, (16,)).init(jax.random.PRNGKey(i))
        # sharper logits than init's, so the draws decide different moves
        weights[pid] = {k: np.asarray(v) * (30.0 if k == "pi_out_w" else 1.0)
                        for k, v in p.items()}
    T, seed = 12, 5
    draws = jax_draws(seed, 2, T * len(agents))
    monkeypatch.setattr(pmodels, "_gumbel", lambda gen, shape: draws.pop(0))
    jr = JaxRunner(lambda: RockPaperScissors(episode_len=5), specs, mapping,
                   seed=seed)
    pr = MultiAgentEnvRunner(lambda: RockPaperScissors(episode_len=5), specs,
                             mapping, seed=seed, device="cpu")
    for _ in range(2):
        want, got = jr.sample(weights, T), pr.sample(weights, T)
        assert want.keys() == got.keys() == set(pids)
        for pid in pids:
            assert want[pid].keys() == got[pid].keys()
            for k in ("obs", "actions", "rewards", "dones"):
                np.testing.assert_array_equal(got[pid][k], want[pid][k],
                                              err_msg=f"{pid} {k}")
            for k in ("logp", "values", "last_values"):
                np.testing.assert_allclose(got[pid][k], want[pid][k],
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{pid} {k}")
    assert not draws
    assert len(set(want[pids[0]]["actions"].ravel().tolist())) > 1
    assert pr.episode_returns() == jr.episode_returns()


def test_multi_agent_ppo_two_policies():
    """The reference's test (tests/test_rllib_impala.py): two policies train
    against each other on RPS, per-policy batches and learners, the runners
    actors."""
    from ray_tpu_torch.rllib import MultiAgentPPO, RockPaperScissors

    algo = MultiAgentPPO(
        env_ctor=lambda: RockPaperScissors(episode_len=8),
        policy_mapping_fn=lambda aid: aid,
        num_runners=2, rollout_len=48,
        train_config={"lr": 3e-3}, seed=0, device="cpu")
    try:
        result = None
        for _ in range(3):
            result = algo.train()
        assert "player_0/policy_loss" in result
        assert "player_1/policy_loss" in result
        assert np.isfinite(result["player_0/policy_loss"])
        r0 = result.get("player_0/episode_return_mean")
        r1 = result.get("player_1/episode_return_mean")
        assert r0 is not None and r1 is not None
        assert abs(r0 + r1) < 1e-6
    finally:
        algo.stop()


def test_multi_agent_ppo_updates_each_policy_from_its_rollout(monkeypatch):
    """One iteration: each policy's learner takes the rollout of the agents
    mapped to it, concatenated along B over the runners, and ends where a
    fresh Learner from the same seed ends on that rollout."""
    from ray_tpu_torch.rllib import Learner, MultiAgentPPO, RockPaperScissors
    from ray_tpu_torch.rllib.models import build_model

    algo = MultiAgentPPO(
        env_ctor=lambda: RockPaperScissors(episode_len=8),
        policy_mapping_fn=lambda aid: aid, num_runners=2, rollout_len=16,
        hidden=(8,), seed=3, device="cpu")
    seen = {}
    for pid, lrn in algo.learners.items():
        upd = lrn.update

        def recording(rollout, upd=upd, pid=pid):
            seen[pid] = rollout
            return upd(rollout)
        monkeypatch.setattr(lrn, "update", recording)
    try:
        algo.train()
    finally:
        algo.stop()
    for i, pid in enumerate(algo.policy_ids):
        assert seen[pid]["obs"].shape == (16, 2, 4)
        fresh = Learner(build_model(algo.model_specs[pid]),
                        algo.learners[pid].cfg, seed=3 + i, device="cpu")
        fresh.update(seen[pid])
        w, f = algo.learners[pid].get_weights(), fresh.get_weights()
        for k in w:
            np.testing.assert_array_equal(w[k], f[k], err_msg=k)
