"""The port's PPO learner, LearnerGroup's dp split, EnvRunner and the PPO
driver against the JAX package's (ray_tpu/rllib/learner.py, env_runner.py)
on the CPU, in f32: JAX's ``init`` params carried over, JAX's per-epoch
permutations fed to the port through ``learner._permutation``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.rllib import learner as plearner


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: under the suite's parallel
    workers torch's threads oversubscribe the cores.  No tolerance here
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


UPDATE_TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's own tolerance for its dp=4 update (tests/test_rllib.py)
DP_TOL = dict(rtol=2e-4, atol=2e-5)


def carry(jax_params):
    return params_from_numpy({k: np.asarray(v) for k, v in
                              jax_params.items()}, "cpu")


def models(continuous=False, hidden=(16, 16)):
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    return (JaxMLP(4, 2, hidden, continuous=continuous),
            ActorCriticMLP(4, 2, hidden, continuous=continuous))


def rollout(jm, jparams, T=16, B=4, seed=0):
    """A rollout at the runner's layout, its logp from JAX's model (so the
    ratio starts at 1, as after a real rollout)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, 4)).astype(np.float32)
    if jm.continuous:
        actions = rng.standard_normal((T, B, 2)).astype(np.float32)
    else:
        actions = rng.integers(0, 2, (T, B)).astype(np.float32)
    pi, _ = jm.apply(jparams, jnp.asarray(obs.reshape(T * B, 4)))
    logp = np.asarray(jm.log_prob(
        pi, jnp.asarray(actions.reshape(T * B, *actions.shape[2:]))))
    return {
        "obs": obs, "actions": actions,
        "logp": logp.reshape(T, B).astype(np.float32),
        "values": rng.standard_normal((T, B)).astype(np.float32),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
        "last_values": rng.standard_normal(B).astype(np.float32),
    }


def port_learner(pm, cfg, jl, seed=0):
    """A port learner on the CPU holding the JAX learner's params."""
    pl = plearner.Learner(pm, cfg, seed=seed, device="cpu")
    pl.params = carry(jl.params)
    pl.opt_state = pl.opt.init(plearner.leaves(pl.params))
    return pl


def jax_permutations(jl, epochs, n):
    """The permutations the JAX learner's next update draws."""
    _, sub = jax.random.split(jl._key)
    return [torch.from_numpy(np.array(jax.random.permutation(k, n)))
            for k in jax.random.split(sub, epochs)]


def test_gae_matches_jax():
    from ray_tpu.rllib.learner import Learner as JaxLearner

    jm, pm = models()
    cfg = {"gamma": 0.97, "lambda": 0.9}
    jl = JaxLearner(jm, cfg)
    pl = plearner.Learner(pm, cfg, device="cpu")
    r = rollout(jm, jl.params, T=128, B=4)
    want = jax.jit(jl._gae)(*(jnp.asarray(r[k]) for k in
                              ("rewards", "values", "dones", "last_values")))
    got = pl._gae(*(torch.from_numpy(r[k]) for k in
                    ("rewards", "values", "dones", "last_values")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_loss_and_grads_match_jax(continuous):
    from ray_tpu.rllib.learner import Learner as JaxLearner

    jm, pm = models(continuous)
    cfg = {"entropy_coeff": 0.01, "clip_param": 0.1, "vf_clip_param": 0.5}
    jl = JaxLearner(jm, cfg)
    r = rollout(jm, jl.params, T=8, B=4)
    rng = np.random.default_rng(1)
    n = 32
    batch = {
        "obs": r["obs"].reshape(n, 4),
        "actions": r["actions"].reshape(n, *r["actions"].shape[2:]),
        # off-policy logp, so that the ratio clip binds somewhere
        "logp": (r["logp"].reshape(n)
                 + 0.3 * rng.standard_normal(n)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "returns": (3 * rng.standard_normal(n)).astype(np.float32),
    }
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jl._loss, has_aux=True))(jl.params, {k: jnp.asarray(v) for k, v in
                                             batch.items()}, None)
    pl = port_learner(pm, cfg, jl)
    p = {k: v.requires_grad_() for k, v in pl.params.items()}
    ploss, paux = pl._loss(p, {k: torch.from_numpy(v) for k, v in
                               batch.items()})
    grads = dict(zip(p, torch.autograd.grad(ploss, list(p.values()))))
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5,
                               atol=1e-6)
    for k in jaux:
        np.testing.assert_allclose(paux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in jgrads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_two_updates_match_jax(continuous, monkeypatch):
    """Two updates of 2 epochs x 2 minibatches (GAE, normalisation, the
    clip by global norm, Adam) with JAX's permutations: every leaf and the
    metrics within 1e-4."""
    from ray_tpu.rllib.learner import Learner as JaxLearner

    jm, pm = models(continuous)
    cfg = {"lr": 1e-2, "num_epochs": 2, "num_minibatches": 2,
           "entropy_coeff": 0.01, "grad_clip": 0.5}
    jl = JaxLearner(jm, cfg, seed=3)
    pl = port_learner(pm, cfg, jl)
    perms = []
    monkeypatch.setattr(plearner, "_permutation",
                        lambda gen, n: perms.pop(0))
    for step in range(2):
        r = rollout(jm, jl.params, T=16, B=4, seed=step)
        # n = 64 rows; 2 minibatches of 32; drawn before JAX's key moves
        perms.extend(jax_permutations(jl, 2, 64))
        jmetrics = jl.update(r)
        pmetrics = pl.update(r)
        assert not perms
        assert set(pmetrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(pmetrics[k], jmetrics[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        jw, pw = jl.get_weights(), pl.get_weights()
        for k in jw:
            np.testing.assert_allclose(pw[k], jw[k], **UPDATE_TOL,
                                       err_msg=f"step {step} {k}")


def test_leftover_rows_are_dropped_like_jax(monkeypatch):
    """n mod num_minibatches rows sit out each epoch, as in JAX."""
    from ray_tpu.rllib.learner import Learner as JaxLearner

    jm, pm = models()
    cfg = {"lr": 1e-2, "num_epochs": 1, "num_minibatches": 3}
    jl = JaxLearner(jm, cfg, seed=5)
    pl = port_learner(pm, cfg, jl)
    r = rollout(jm, jl.params, T=10, B=4)       # 40 rows, 3 x 13 + 1
    perms = jax_permutations(jl, 1, 40)
    monkeypatch.setattr(plearner, "_permutation",
                        lambda gen, n: perms.pop(0))
    jl.update(r)
    pl.update(r)
    jw, pw = jl.get_weights(), pl.get_weights()
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], **UPDATE_TOL, err_msg=k)


@pytest.mark.parametrize("num_learners", [2, 4])
def test_learner_group_dp_matches_single(num_learners):
    """The reference's dp test on the port: the batch split over CPU
    devices gives the single-device update."""
    from ray_tpu_torch.rllib.learner import LearnerGroup
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    cfg = {"lr": 1e-3, "num_epochs": 2, "num_minibatches": 2}
    rng = np.random.RandomState(2)
    T, B = 16, 8
    roll = {
        "obs": rng.randn(T, B, 4).astype(np.float32),
        "actions": rng.randint(0, 2, (T, B)).astype(np.float32),
        "logp": np.full((T, B), np.log(0.5), np.float32),
        "values": rng.randn(T, B).astype(np.float32),
        "rewards": rng.randn(T, B).astype(np.float32),
        "dones": (rng.rand(T, B) < 0.1).astype(np.float32),
        "last_values": rng.randn(B).astype(np.float32),
    }
    single = LearnerGroup(ActorCriticMLP(4, 2, (16,)), cfg, num_learners=1,
                          seed=7, device="cpu")
    sharded = LearnerGroup(ActorCriticMLP(4, 2, (16,)), cfg,
                           num_learners=num_learners, seed=7, device="cpu")
    assert len(sharded.learner.devices) == num_learners
    for _ in range(2):
        m1 = single.update(dict(roll))
        mn = sharded.update(dict(roll))
    for k in m1:
        np.testing.assert_allclose(mn[k], m1[k], **DP_TOL, err_msg=k)
    w1, wn = single.get_weights(), sharded.get_weights()
    for k in w1:
        np.testing.assert_allclose(wn[k], w1[k], **DP_TOL, err_msg=k)


def test_learner_update_improves_objective():
    """The reference's test on the port: a few updates on a fixed synthetic
    advantage signal move the policy toward the advantaged action."""
    from ray_tpu_torch.rllib.learner import Learner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    model = ActorCriticMLP(obs_dim=4, action_dim=2, hidden=(16,))
    lrn = Learner(model, {"lr": 1e-2, "num_epochs": 2, "num_minibatches": 2,
                          "entropy_coeff": 0.0, "gamma": 0.0, "lambda": 0.0},
                  device="cpu")
    rng = np.random.RandomState(1)
    T, B = 32, 4
    obs = rng.randn(T, B, 4).astype(np.float32)
    actions = rng.randint(0, 2, (T, B)).astype(np.float32)
    roll = {
        "obs": obs,
        "actions": actions,
        "logp": np.full((T, B), np.log(0.5), np.float32),
        "values": np.zeros((T, B), np.float32),
        "rewards": actions.copy(),  # action 1 rewarded, action 0 not
        "dones": np.zeros((T, B), np.float32),
        "last_values": np.zeros((B,), np.float32),
    }
    flat = torch.from_numpy(obs.reshape(-1, 4))
    prob0 = float(torch.softmax(model.apply(lrn.params, flat)[0],
                                -1)[:, 1].mean())
    for _ in range(3):
        lrn.update(roll)
    prob1 = float(torch.softmax(model.apply(lrn.params, flat)[0],
                                -1)[:, 1].mean())
    assert prob1 > prob0 + 0.05, f"policy did not move: {prob0} -> {prob1}"
