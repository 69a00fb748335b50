"""The port's external-env protocol (ray_tpu_torch/rllib/external.py): the
reference's runtime-free tests (tests/test_rllib_external.py) on the
port's ``PolicyServerInput``, each driven by the port's ``PolicyClient``
and by the reference's (one wire); ``PPOConfig.external`` training from a
CartPole simulator over HTTP with PPO in-process, again with either
client."""

import threading

import numpy as np
import pytest
import torch

import gymnasium as gym


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


SPEC = dict(obs_dim=4, action_dim=2, hidden=(16,), continuous=False)


def _serve(model_spec, port=0, fragment_len=8, **kw):
    from ray_tpu_torch.rllib.external import PolicyServerInput
    from ray_tpu_torch.rllib.models import build_model

    model = build_model(model_spec)
    params = model.init(torch.Generator().manual_seed(0))
    return PolicyServerInput(model, params, port=port,
                             fragment_len=fragment_len, device="cpu", **kw)


@pytest.fixture(params=["port", "reference"])
def client_cls(request):
    """Either package's PolicyClient: the wire is the same."""
    if request.param == "port":
        from ray_tpu_torch.rllib import PolicyClient
    else:
        from ray_tpu.rllib.external import PolicyClient
    return PolicyClient


def test_episode_stream_and_fragments(client_cls):
    """Commands append contiguous per-episode fragments; rewards attach to
    the step that earned them."""
    srv = _serve(SPEC, fragment_len=4)
    try:
        client = client_cls(srv.address)
        eid = client.start_episode()
        for t in range(3):
            a = client.get_action(eid, np.ones(4) * t)
            assert a in (0, 1)
            client.log_returns(eid, 1.0)
        client.end_episode(eid)
        batch = srv.next(3, timeout=10)
        assert batch["obs"].shape == (3, 1, 4)
        assert batch["rewards"].ravel().tolist() == [1.0, 1.0, 1.0]
        assert batch["dones"].ravel().tolist() == [0.0, 0.0, 1.0]
        assert batch["last_values"].tolist() == [0.0]
        assert srv.episode_returns() == [3.0]
    finally:
        srv.stop()


def test_fragment_flush_mid_episode(client_cls):
    """A long episode flushes fixed-size fragments without waiting for
    end_episode; the cut step carries the folded bootstrap."""
    srv = _serve(SPEC, fragment_len=4, gamma=0.5)
    try:
        client = client_cls(srv.address)
        eid = client.start_episode()
        obs = [np.ones(4) * (t + 1) for t in range(6)]
        for o in obs:
            client.get_action(eid, o)
            client.log_returns(eid, 2.0)
        batch = srv.next(4, timeout=10)  # flushed at the 5th get_action
        assert batch["dones"].ravel().tolist() == [0.0, 0.0, 0.0, 1.0]
        r = batch["rewards"].ravel()
        assert r[:3].tolist() == [2.0, 2.0, 2.0]
        # 2.0 + gamma * V(the 5th observation), V from the served params
        _, v = srv.model.apply(srv._params, torch.tensor(
            obs[4][None], dtype=torch.float32))
        np.testing.assert_allclose(r[3], np.float32(2.0 + 0.5 * v.item()),
                                   rtol=1e-6)
        client.end_episode(eid)
    finally:
        srv.stop()


def test_truncated_end_folds_bootstrap(client_cls):
    """A time-limit end (truncated=True + final obs) folds gamma*V into the
    last reward instead of training a fake terminal."""
    srv = _serve(SPEC, fragment_len=100, gamma=0.5)
    try:
        client = client_cls(srv.address)
        eid = client.start_episode()
        client.get_action(eid, np.ones(4))
        client.log_returns(eid, 1.0)
        client.end_episode(eid, np.ones(4) * 2, truncated=True)
        truncated = srv.next(1, timeout=10)

        eid = client.start_episode()
        client.get_action(eid, np.ones(4))
        client.log_returns(eid, 1.0)
        client.end_episode(eid, np.ones(4) * 2)  # true terminal
        terminal = srv.next(1, timeout=10)

        assert terminal["rewards"].ravel().tolist() == [1.0]
        assert truncated["rewards"].ravel()[0] != 1.0  # + 0.5 * V(final)
        assert truncated["dones"].ravel().tolist() == [1.0]
    finally:
        srv.stop()


def test_log_action_and_weights(client_cls):
    """Client-side inference: pull weights, act locally, log the action;
    ``set_weights`` serves a new version."""
    srv = _serve(SPEC, fragment_len=100)
    try:
        client = client_cls(srv.address)
        weights, version = client.get_weights()
        assert version == 0 and isinstance(weights, dict)
        for k, v in srv._params.items():
            np.testing.assert_array_equal(weights[k], v.numpy())
        eid = client.start_episode()
        client.log_action(eid, np.zeros(4), 1)
        client.log_returns(eid, 0.5)
        client.end_episode(eid)
        batch = srv.next(1, timeout=10)
        assert batch["actions"].ravel().tolist() == [1.0]
        assert batch["rewards"].ravel().tolist() == [0.5]
        with pytest.raises(RuntimeError, match="unknown episode"):
            client.get_action("nope", np.zeros(4))
        new = {k: v * 2.0 for k, v in weights.items()}
        srv.set_weights(new)
        got, version = client.get_weights()
        assert version == 1
        for k in new:
            np.testing.assert_array_equal(got[k], new[k])
    finally:
        srv.stop()


def test_continuous_actions_stream():
    """A Gaussian policy: actions come back as vectors and their logp is
    the density's under the served mean and std."""
    from ray_tpu_torch.rllib import PolicyClient

    srv = _serve(dict(obs_dim=3, action_dim=2, hidden=(8,),
                      continuous=True), fragment_len=100)
    try:
        client = PolicyClient(srv.address)
        eid = client.start_episode()
        obs = np.array([0.5, -1.0, 2.0], np.float32)
        a = np.asarray(client.get_action(eid, obs))
        client.log_returns(eid, 1.0)
        client.end_episode(eid)
        batch = srv.next(1, timeout=10)
        assert a.shape == (2,) and batch["actions"].shape == (1, 1, 2)
        np.testing.assert_allclose(batch["actions"][0, 0], a, rtol=1e-6)
        pi, _ = srv.model.apply(srv._params, torch.from_numpy(obs[None]))
        want = srv.model.log_prob(pi, torch.from_numpy(
            a[None].astype(np.float32)))
        np.testing.assert_allclose(batch["logp"][0, 0], want.item(),
                                   rtol=1e-4, atol=1e-5)
    finally:
        srv.stop()


def test_external_ppo_trains(client_cls):
    """The reference's end-to-end test with PPO in-process: a CartPole
    simulator in a thread talks HTTP only."""
    from ray_tpu_torch.rllib import PPOConfig

    probe = gym.make("CartPole-v1")
    config = (PPOConfig()
              .environment(observation_space=probe.observation_space,
                           action_space=probe.action_space)
              .external(port=0)
              .env_runners(rollout_fragment_length=256)
              .training(num_epochs=2, num_minibatches=2,
                        model={"hidden": (32, 32)}))
    probe.close()
    algo = config.build(device="cpu")
    stop = threading.Event()
    errors = []

    def simulator():
        env = gym.make("CartPole-v1")
        client = client_cls(algo.policy_server.address)
        try:
            while not stop.is_set():
                eid = client.start_episode()
                obs, _ = env.reset()
                term = trunc = False
                while not (term or trunc) and not stop.is_set():
                    action = client.get_action(eid, obs)
                    obs, reward, term, trunc, _ = env.step(action)
                    client.log_returns(eid, reward)
                client.end_episode(eid, obs, truncated=trunc and not term)
        except Exception as e:  # only teardown races are expected
            if not stop.is_set():
                errors.append(e)
        finally:
            env.close()

    sim = threading.Thread(target=simulator, daemon=True)
    sim.start()
    try:
        results = [algo.train() for _ in range(3)]
        assert results[-1]["training_iteration"] == 3
        assert results[-1]["num_env_steps_sampled"] == 3 * 256
        assert np.isfinite(results[-1]["policy_loss"])
        assert results[-1]["episode_return_mean"] > 0
        assert algo.policy_server._params_version == 3
    finally:
        stop.set()
        algo.stop()
        sim.join(timeout=10)
    assert not sim.is_alive()
    assert not errors, errors
