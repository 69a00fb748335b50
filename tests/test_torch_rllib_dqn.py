"""The port's DQN and Rainbow updates and DQNRunner against the JAX
package's (ray_tpu/rllib/dqn.py, rainbow.py) on the CPU, in f32: JAX's
params, target and batches, three updates each (double-Q on and off,
n-step discounts with terminal zeros, PER weights, the Polyak target).
The reference's drivers place their runners as actors, so JAX's update
is built without its constructor; its runner is a plain class."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.rllib.learner import leaves


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


TOL = dict(rtol=1e-4, atol=1e-5)


def carry(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def jax_algo(cls, config, model_spec):
    """The JAX driver's update alone: the reference builds it from the
    config, the model and the optimizer (its runners need the runtime)."""
    from ray_tpu.rllib.dqn import build_q_model

    algo = cls.__new__(cls)
    algo.config = config
    algo.model = build_q_model(model_spec)
    algo.opt = optax.adam(config.train["lr"])
    return algo, algo._build_update()


def batches(obs_dim, action_dim, n, count, weights, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        k = rng.integers(1, 4, n)
        disc = (0.99 ** k).astype(np.float32)
        disc[rng.random(n) < 0.2] = 0.0         # terminal windows
        b = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
             "actions": rng.integers(0, action_dim, n).astype(np.int32),
             "rewards": rng.uniform(-1, 2, n).astype(np.float32),
             "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
             "discounts": disc}
        if weights:
            w = rng.uniform(0.2, 1.0, n).astype(np.float32)
            b["weights"] = w / w.max()
        out.append(b)
    return out


CASES = [("dqn", True, True), ("dqn", False, False),
         ("rainbow", True, True), ("rainbow", False, False)]


@pytest.mark.parametrize("algo,double_q,per", CASES,
                         ids=[f"{a}-double{int(d)}-per{int(p)}"
                              for a, d, p in CASES])
def test_updates_match_jax(algo, double_q, per):
    from ray_tpu.rllib import dqn as jdqn, rainbow as jrainbow
    from ray_tpu_torch.rllib import dqn as pdqn, rainbow as prainbow

    obs_dim, action_dim = 4, 3
    kw = dict(lr=5e-3, batch_size=32, target_update_tau=0.1,
              double_q=double_q)
    if algo == "dqn":
        jcls, jcfg = jdqn.DQN, jdqn.DQNConfig().training(
            model=dict(hidden=(32, 32)), **kw)
        pcls, pcfg = pdqn.DQN, pdqn.DQNConfig().training(
            model=dict(hidden=(32, 32)), **kw)
    else:
        head = dict(hidden=(32,), num_atoms=11, v_min=-1.0, v_max=4.0)
        jcls, jcfg = jrainbow.Rainbow, jrainbow.RainbowConfig().training(
            model=head, **kw)
        pcls, pcfg = prainbow.Rainbow, prainbow.RainbowConfig().training(
            model=head, **kw)
    port = pcls.learner_only(pcfg, obs_dim, action_dim, device="cpu")
    jalgo, jupdate = jax_algo(jcls, jcfg, port.model_spec)
    params = jalgo.model.init(jax.random.PRNGKey(0))
    if algo == "rainbow":   # spread the atoms, so the projection matters
        params = dict(params, adv_w=params["adv_w"] * 50.0)
    target = jalgo.model.init(jax.random.PRNGKey(1))
    opt_state = jalgo.opt.init(params)
    port.params, port.target_params = carry(params), carry(target)
    port.opt_state = port.opt.init(leaves(port.params))

    for i, b in enumerate(batches(obs_dim, action_dim, 32, 3, per)):
        params, target, opt_state, jloss, jaux = jupdate(
            params, target, opt_state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        (port.params, port.target_params, port.opt_state, ploss,
         paux) = port._update(port.params, port.target_params,
                              port.opt_state,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(ploss.item(), float(jloss), **TOL,
                                   err_msg=f"loss, update {i}")
        np.testing.assert_allclose(paux.numpy(), np.asarray(jaux), **TOL,
                                   err_msg=f"td/ce, update {i}")
        for name, jt, pt in (("params", params, port.params),
                             ("target", target, port.target_params)):
            for k in jt:
                np.testing.assert_allclose(
                    pt[k].numpy(), np.asarray(jt[k]), **TOL,
                    err_msg=f"{name}[{k}], update {i}")


def test_dqn_runner_transitions_equal_the_reference():
    """n-step 3, epsilon 0.3, two envs: with JAX's params the port's runner
    gives the reference's transitions bit for bit."""
    from ray_tpu.rllib.dqn import DQNRunner as JaxRunner, QNetwork
    from ray_tpu_torch.rllib.dqn import DQNRunner

    spec = dict(obs_dim=4, action_dim=2, hidden=(32, 32))
    weights = jax.tree_util.tree_map(
        np.asarray, QNetwork(**spec).init(jax.random.PRNGKey(3)))
    jr = JaxRunner("CartPole-v1", spec, num_envs=2, seed=5)
    pr = DQNRunner("CartPole-v1", spec, num_envs=2, seed=5, device="cpu")
    for eps in (0.3, 0.05):
        want = jr.sample(weights, 96, eps, n_step=3, gamma=0.9)
        got = pr.sample(weights, 96, eps, n_step=3, gamma=0.9)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (want["discounts"] == 0).any()
    assert pr.episode_returns() == jr.episode_returns()


def test_dqn_driver_runs_in_process():
    pytest.importorskip("gymnasium")
    from ray_tpu_torch.rllib.dqn import DQNConfig

    algo = (DQNConfig()
            .environment("CartPole-v1")
            .env_runners(rollout_steps=200)
            .training(batch_size=32, train_iters=2,
                      replay=dict(capacity=5_000, learn_starts=100,
                                  prioritized=True))
            .build(device="cpu"))
    try:
        for _ in range(3):
            result = algo.train()
        assert result["replay_size"] == 600
        assert np.isfinite(result["loss"])
        assert result["num_env_steps_sampled"] == 600
    finally:
        algo.stop()
