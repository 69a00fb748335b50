"""The port's RL models, replay buffers and example envs against the JAX
package's (ray_tpu_torch/rllib against ray_tpu/rllib) on the CPU, in f32:
JAX's ``init`` params carried over with ``params_from_numpy``, the same
numpy inputs, 1e-5 on every output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu_torch.models.convert import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: under the suite's parallel
    workers torch's threads oversubscribe the cores.  No tolerance here
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-5)


def carry(jax_params):
    """JAX's params as the port's CPU tensors."""
    return params_from_numpy({k: np.asarray(v) for k, v in
                              jax_params.items()}, "cpu")


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_actor_critic_mlp_matches_jax(continuous):
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    jm = JaxMLP(obs_dim=5, action_dim=3, hidden=(16, 8),
                continuous=continuous)
    pm = ActorCriticMLP(obs_dim=5, action_dim=3, hidden=(16, 8),
                        continuous=continuous)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # a larger pi head, so log_std reaches both clip bounds
    jp = dict(jp, pi_out_w=jp["pi_out_w"] * 300.0)
    pp = carry(jp)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((7, 5)).astype(np.float32)
    if continuous:
        act = rng.standard_normal((7, 3)).astype(np.float32)
    else:
        act = rng.integers(0, 3, 7).astype(np.float32)
    jpi, jv = jax.jit(jm.apply)(jp, jnp.asarray(obs))
    ppi, pv = pm.apply(pp, t(obs))
    np.testing.assert_allclose(ppi.numpy(), np.asarray(jpi), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(pm.log_prob(ppi, t(act)).numpy(),
                               np.asarray(jm.log_prob(jpi, jnp.asarray(act))),
                               **TOL)
    np.testing.assert_allclose(pm.entropy(ppi).numpy(),
                               np.asarray(jm.entropy(jpi)), **TOL)
    if continuous:
        log_std = np.asarray(jpi)[:, 3:]
        assert log_std.min() < -5.0 and log_std.max() > 2.0


def test_actor_critic_conv_matches_jax_at_nature_width():
    """(84, 84, 4) uint8 frames through the Nature filters: the HWIO
    weights and torso_w's NHWC row order must be honoured, or the outputs
    differ (and may still look plausible)."""
    from ray_tpu.rllib.conv import ActorCriticConv as JaxConv
    from ray_tpu_torch.rllib.conv import NATURE_FILTERS, ActorCriticConv

    jm = JaxConv(obs_shape=(84, 84, 4), action_dim=6)
    pm = ActorCriticConv(obs_shape=(84, 84, 4), action_dim=6)
    assert pm.filters == NATURE_FILTERS and pm.hidden_size == 512
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # a wider pi head, so the logits are well above the f32 noise
    jp = dict(jp, pi_out_w=jp["pi_out_w"] * 100.0)
    pp = carry(jp)
    assert {k: tuple(v.shape) for k, v in pp.items()} == {
        k: tuple(v.shape) for k, v in pm.init(torch.Generator()).items()}
    frames = np.random.default_rng(1).integers(
        0, 256, (2, 84, 84, 4)).astype(np.uint8)
    jpi, jv = jax.jit(jm.apply)(jp, jnp.asarray(frames))
    ppi, pv = pm.apply(pp, t(frames))
    assert ppi.shape == (2, 6) and pv.shape == (2,)
    np.testing.assert_allclose(ppi.numpy(), np.asarray(jpi), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    # an unbatched frame is one row
    ppi1, _ = pm.apply(pp, t(frames[0]))
    np.testing.assert_allclose(ppi1.numpy(), ppi[:1].numpy(), **TOL)


def test_q_network_matches_jax():
    from ray_tpu.rllib.dqn import QNetwork as JaxQ
    from ray_tpu_torch.rllib.dqn import QNetwork

    jq, pq = JaxQ(4, 3, (32, 16)), QNetwork(4, 3, (32, 16))
    jp = jq.init(jax.random.PRNGKey(2))
    obs = np.random.default_rng(2).standard_normal((9, 4)).astype(np.float32)
    np.testing.assert_allclose(pq.apply(carry(jp), t(obs)).numpy(),
                               np.asarray(jq.apply(jp, jnp.asarray(obs))),
                               **TOL)


@pytest.mark.parametrize("dueling", [True, False])
def test_dist_q_network_matches_jax(dueling):
    from ray_tpu.rllib.rainbow import DistQNetwork as JaxDQ
    from ray_tpu_torch.rllib.rainbow import DistQNetwork

    kw = dict(obs_dim=3, action_dim=2, hidden=(16,), num_atoms=11,
              v_min=-5.0, v_max=5.0, dueling=dueling)
    jn, pn = JaxDQ(**kw), DistQNetwork(**kw)
    jp = jax.jit(jn.init)(jax.random.PRNGKey(0))
    jp = dict(jp, adv_w=jp["adv_w"] * 100.0)   # spread the distributions
    pp = carry(jp)
    obs = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)
    p = pn.probs(pp, t(obs))
    assert p.shape == (4, 2, 11)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(p.numpy(),
                               np.asarray(jn.probs(jp, jnp.asarray(obs))),
                               **TOL)
    np.testing.assert_allclose(
        pn.log_probs(pp, t(obs)).numpy(),
        np.asarray(jn.log_probs(jp, jnp.asarray(obs))), **TOL)
    q = pn.apply(pp, t(obs))
    assert q.shape == (4, 2)
    assert (q.numpy() >= -5.0).all() and (q.numpy() <= 5.0).all()
    np.testing.assert_allclose(q.numpy(),
                               np.asarray(jn.apply(jp, jnp.asarray(obs))),
                               **TOL)


def test_dueling_center_invariance():
    """The reference's test on the port: adding a constant to every
    advantage atom logit leaves the distribution unchanged."""
    from ray_tpu_torch.rllib.rainbow import DistQNetwork

    net = DistQNetwork(obs_dim=2, action_dim=3, hidden=(8,), num_atoms=5,
                       dueling=True)
    params = net.init(torch.Generator().manual_seed(1))
    obs = torch.ones((2, 2))
    p0 = net.probs(params, obs)
    shifted = dict(params, adv_b=params["adv_b"] + 3.7)
    np.testing.assert_allclose(net.probs(shifted, obs).numpy(), p0.numpy(),
                               atol=1e-5)


def test_squashed_gaussian_sample_with_jax_eps(monkeypatch):
    from ray_tpu.rllib.sac import SquashedGaussianPolicy as JaxPi
    from ray_tpu_torch.rllib import sac
    from ray_tpu_torch.rllib.sac import SquashedGaussianPolicy

    jpi, ppi = JaxPi(3, 2, (32, 32)), SquashedGaussianPolicy(3, 2, (32, 32))
    jp = jax.jit(jpi.init)(jax.random.PRNGKey(4))
    jp = dict(jp, w2=jp["w2"] * 400.0)   # log_std reaches both clip bounds
    obs = np.random.default_rng(4).standard_normal((6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, (6, 2)))
    monkeypatch.setattr(sac, "_normal", lambda gen, shape: t(eps))
    ja, jlp = jax.jit(jpi.sample)(jp, jnp.asarray(obs), key)
    pa, plp = ppi.sample(carry(jp), t(obs), torch.Generator())
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), **TOL)
    _, log_std = ppi.forward(carry(jp), t(obs))
    assert log_std.min() == -10.0 and log_std.max() == 2.0


def test_q_sa_and_deterministic_policy_match_jax():
    from ray_tpu.rllib.sac import QNetworkSA as JaxQSA
    from ray_tpu.rllib.td3 import DeterministicPolicy as JaxDet
    from ray_tpu_torch.rllib.sac import QNetworkSA
    from ray_tpu_torch.rllib.td3 import DeterministicPolicy

    rng = np.random.default_rng(6)
    obs = rng.standard_normal((5, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    jq, pq = JaxQSA(3, 2, (32, 32)), QNetworkSA(3, 2, (32, 32))
    jp = jq.init(jax.random.PRNGKey(6))
    np.testing.assert_allclose(
        pq.apply(carry(jp), t(obs), t(act)).numpy(),
        np.asarray(jq.apply(jp, jnp.asarray(obs), jnp.asarray(act))), **TOL)
    jd, pd = JaxDet(3, 2, (32, 32)), DeterministicPolicy(3, 2, (32, 32))
    jp = jd.init(jax.random.PRNGKey(7))
    jp = dict(jp, w2=jp["w2"] * 100.0)
    np.testing.assert_allclose(pd.apply(carry(jp), t(obs)).numpy(),
                               np.asarray(jd.apply(jp, jnp.asarray(obs))),
                               **TOL)


def test_port_init_keeps_the_reference_tree():
    """Every model's ``init`` gives JAX's keys, shapes and dtypes."""
    from ray_tpu.rllib import conv as jconv, dqn as jdqn, models as jmodels
    from ray_tpu.rllib import rainbow as jrainbow, sac as jsac, td3 as jtd3
    from ray_tpu_torch.rllib import conv, dqn, models, rainbow, sac, td3

    pairs = [
        (jmodels.ActorCriticMLP(4, 2, (8, 8), continuous=True),
         models.ActorCriticMLP(4, 2, (8, 8), continuous=True)),
        (jconv.ActorCriticConv((12, 12, 1), 3, ((4, 4, 2), (8, 3, 1)), 32),
         conv.ActorCriticConv((12, 12, 1), 3, ((4, 4, 2), (8, 3, 1)), 32)),
        (jdqn.QNetwork(4, 2, (8,)), dqn.QNetwork(4, 2, (8,))),
        (jrainbow.DistQNetwork(4, 2, (8,), 5), rainbow.DistQNetwork(4, 2,
                                                                    (8,), 5)),
        (jsac.SquashedGaussianPolicy(3, 1, (8,)),
         sac.SquashedGaussianPolicy(3, 1, (8,))),
        (jsac.QNetworkSA(3, 1, (8,)), sac.QNetworkSA(3, 1, (8,))),
        (jtd3.DeterministicPolicy(3, 1, (8,)),
         td3.DeterministicPolicy(3, 1, (8,))),
    ]
    for jm, pm in pairs:
        jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        pp = pm.init(torch.Generator().manual_seed(0))
        assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jp.items()} == {
            k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in pp.items()}, type(pm).__name__


# --------------------------------------------------------------- replay

def test_uniform_replay_buffer():
    from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer

    buf = ReplayBuffer(capacity=100, seed=0)
    buf.add({"x": np.arange(10), "y": np.ones((10, 2))})
    assert len(buf) == 10
    s = buf.sample(4)
    assert s["x"].shape == (4,) and s["y"].shape == (4, 2)
    # ring wrap: capacity bounds the size
    for _ in range(20):
        buf.add({"x": np.arange(10), "y": np.ones((10, 2))})
    assert len(buf) == 100


def test_prioritized_replay_buffer():
    from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer

    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, beta=1.0, seed=0)
    buf.add({"x": np.arange(64)})
    # give one transition overwhelming priority -> it should dominate samples
    buf.update_priorities([7], [1000.0])
    counts = np.zeros(64)
    for _ in range(50):
        s = buf.sample(8)
        for i in s["_indices"]:
            counts[i] += 1
    assert counts[7] == counts.max()
    assert "_weights" in buf.sample(8)
    # importance weights: the high-priority sample gets the smallest weight
    s = buf.sample(32)
    w7 = s["_weights"][s["_indices"] == 7]
    if len(w7):
        assert w7.min() <= s["_weights"].max()


def test_sum_tree_prefix_find():
    from ray_tpu_torch.rllib.replay_buffer import _SumTree

    t_ = _SumTree(8)
    for i, p in enumerate([1.0, 2.0, 3.0, 4.0]):
        t_.set(i, p)
    assert t_.total() == 10.0
    assert t_.find(0.5) == 0
    assert t_.find(1.5) == 1
    assert t_.find(9.9) == 3


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_samples_equal_the_reference(prioritized):
    """The copy draws what the reference draws for the same seed."""
    from ray_tpu.rllib import replay_buffer as jrb
    from ray_tpu_torch.rllib import replay_buffer as prb

    bufs = [(m.PrioritizedReplayBuffer(50, seed=3) if prioritized
             else m.ReplayBuffer(50, seed=3)) for m in (jrb, prb)]
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = {"x": rng.standard_normal((20, 2)).astype(np.float32)}
        for b in bufs:
            b.add(batch)
    for _ in range(3):
        got = [b.sample(16) for b in bufs]
        for k in got[0]:
            np.testing.assert_array_equal(got[0][k], got[1][k])
        pr = np.abs(rng.standard_normal(16))
        for b, g in zip(bufs, got):
            b.update_priorities(g["_indices"], pr)


# ------------------------------------------------------------ the envs

@pytest.mark.parametrize("env_cls", ["CatchEnv", "BiasBanditEnv"])
def test_example_env_streams_equal_the_reference(env_cls):
    """The copied classes give the reference's streams.  Both packages
    register the same gymnasium ids (the later registration wins, with a
    warning), so the classes are built directly here."""
    import importlib

    streams = []
    for module in ("ray_tpu.rllib.examples_env",
                   "ray_tpu_torch.rllib.examples_env"):
        env = getattr(importlib.import_module(module), env_cls)()
        rng = np.random.default_rng(9)
        out = []
        for ep in range(3):
            obs, _ = env.reset(seed=ep)
            out.append(obs)
            done = False
            while not done:
                obs, r, term, trunc, _ = env.step(int(rng.integers(
                    0, env.action_space.n)))
                out.extend([obs, np.float32(r)])
                done = term or trunc
        streams.append(out)
    assert len(streams[0]) == len(streams[1])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


def test_example_env_ids_make_through_the_port_module():
    import warnings

    import gymnasium as gym

    from ray_tpu_torch.rllib import examples_env

    for env_id, cls in (("Catch-v0", examples_env.CatchEnv),
                        ("Bandit-v0", examples_env.BiasBanditEnv)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            env = gym.make(f"ray_tpu_torch.rllib.examples_env:{env_id}")
        assert isinstance(env.unwrapped, cls)
