"""The port's ES / ARS (ray_tpu_torch/rllib/es.py) and Ape-X
(ray_tpu_torch/rllib/apex.py) against the JAX package's on the CPU: the
numpy pieces equal, ``ESPolicy`` on JAX's flat ``theta`` (per layer b
then w, ``ravel_pytree``'s order), one ES and one ARS driver update
within 1e-5, ``ReplayShard`` equal, ``_td_abs`` within 1e-5 and one
Ape-X update on a shard's sample within 1e-4; then the reference's
bandit gates on the port.  The reference's drivers place their workers,
samplers and shards as actors, so the JAX side is built without its
constructors: its update expressions (es.py:263-266, apex.py:136-150)
are transcribed here and its DQN update built as tests/
test_torch_rllib_dqn.py builds it."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

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


@pytest.fixture(autouse=True, scope="module")
def runtime():
    """One runtime of the port for this file: the drivers' runners,
    workers and shards are its actors, each on one torch thread."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 << 20,
                       worker_env={"OMP_NUM_THREADS": "1"})
    yield
    ray_tpu_torch.shutdown()


BANDIT = "ray_tpu_torch.rllib.examples_env:Bandit-v0"


# ------------------------------------------------------------------ ES

def test_numpy_pieces_equal_the_reference():
    from ray_tpu.rllib import es as ref
    from ray_tpu_torch.rllib import es as port

    for seed in (0, 1234, 2 ** 40 + 7):
        np.testing.assert_array_equal(port._noise(seed, 257),
                                      ref._noise(seed, 257))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 2)).astype(np.float32)
    np.testing.assert_array_equal(port.centered_rank(x),
                                  ref.centered_rank(x))
    xs = rng.normal(3.0, 2.0, size=(500, 4))
    a, b = ref._RunningStat(4), port._RunningStat(4)
    for chunk in np.array_split(xs, 7):
        for s in (a, b):
            s.merge(float(len(chunk)), chunk.mean(0),
                    ((chunk - chunk.mean(0)) ** 2).sum(0))
    for got, want in zip(b.stats(), a.stats()):
        np.testing.assert_array_equal(got, want)
    assert np.allclose(b.stats()[1], xs.std(0, ddof=1), atol=1e-6)


def test_centered_rank_and_noise_contract():
    """The reference's math tests on the port."""
    from ray_tpu_torch.rllib.es import _noise, centered_rank

    x = np.array([[10.0, -3.0], [0.5, 99.0]], np.float32)
    r = centered_rank(x)
    assert r.min() == -0.5 and r.max() == 0.5
    assert r[1, 1] > r[0, 0] > r[1, 0] > r[0, 1]
    assert np.allclose(centered_rank(x * 1000.0), r)
    a = _noise(1234, 257)
    assert a.shape == (257,) and a.dtype == np.float32
    assert not np.array_equal(a, _noise(1235, 257))


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_es_policy_on_jax_theta(continuous):
    """JAX's theta0 means the same policy in the port: the forward on a
    batch within 1e-5 and the same actions; and a theta raveled from
    distinct layers (b then w per layer) reads back as those layers."""
    from jax.flatten_util import ravel_pytree

    from ray_tpu.rllib.es import ESPolicy as JaxPolicy
    from ray_tpu_torch.rllib.es import ESPolicy

    jp = JaxPolicy(obs_dim=3, action_dim=2, hidden=(8, 6),
                   continuous=continuous, seed=0)
    pp = ESPolicy(obs_dim=3, action_dim=2, hidden=(8, 6),
                  continuous=continuous, seed=0, device="cpu")
    assert pp.dim == jp.dim == 3 * 8 + 8 + 8 * 6 + 6 + 6 * 2 + 2
    # the port's own init in the same layout: each layer's b (zeros) first
    assert not pp.theta0[:8].any() and pp.theta0[8:8 + 24].any()
    rng = np.random.default_rng(1)
    layers = [{"w": rng.standard_normal((i, o)).astype(np.float32),
               "b": rng.standard_normal(o).astype(np.float32)}
              for i, o in ((3, 8), (8, 6), (6, 2))]
    theta_layers = np.asarray(ravel_pytree(layers)[0], np.float32)
    obs = rng.standard_normal((16, 3)).astype(np.float32)
    for theta in (jp.theta0, theta_layers):
        want = np.asarray(jp._forward(theta, obs))
        got = pp.forward(pp.as_theta(theta), torch.from_numpy(obs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        for o in obs[:6]:
            np.testing.assert_allclose(pp.act(theta, o), jp.act(theta, o),
                                       rtol=1e-5, atol=1e-6)


def _jax_update(cfg, theta, eps, w, denom):
    """es.py:263-266's update, jitted as the reference jits it."""
    lr, l2 = float(cfg["lr"]), float(cfg["l2_coeff"])

    def apply_update(theta, eps, w, denom):
        g = (w @ eps) / denom
        return theta + lr * g - lr * l2 * theta
    return np.asarray(jax.jit(apply_update)(theta, eps, w, denom))


@pytest.mark.parametrize("algo", ["es", "ars"])
def test_driver_update_matches_jax(algo):
    """One driver update at the defaults (32 / 16 perturbations, (64, 64),
    CartPole's sizes) from seeded returns: the reference's direction
    weights and its update on the same theta and noise, within 1e-5."""
    from ray_tpu.rllib import es as ref
    from ray_tpu_torch.rllib import ARS, ARSConfig, ES, ESConfig

    cls, cfg = (ES, ESConfig()) if algo == "es" else (ARS, ARSConfig())
    port = cls.learner_only(cfg, 4, 2, device="cpu")
    jpol = ref.ESPolicy(obs_dim=4, action_dim=2, hidden=(64, 64), seed=0)
    port.theta = jpol.theta0.copy()
    n = cfg.cfg["num_perturbations"]
    seeds = [int(s.generate_state(1)[0])
             for s in np.random.SeedSequence(9).spawn(n)]
    rets = np.random.default_rng(2).normal(20, 8, (n, 2)).astype(np.float32)
    ref_cls = ref.ES if algo == "es" else ref.ARS
    w, used, denom = ref_cls._direction_weights(
        types.SimpleNamespace(config=cfg), rets)
    idx = np.flatnonzero(used)
    eps = np.stack([ref._noise(seeds[i], jpol.dim) for i in idx])
    want = _jax_update(cfg.cfg, jpol.theta0, eps, w[idx].astype(np.float32),
                       float(denom))
    port.update_from_returns(seeds, rets)
    assert port.theta.dtype == np.float32
    rel = np.linalg.norm(port.theta - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    assert np.linalg.norm(want - jpol.theta0) > 1e-3   # the step moved it


def _run_bandit(config_cls, iters=12, **train_kw):
    algo = (config_cls()
            .environment(BANDIT)
            .env_runners(num_env_runners=2)
            .training(hidden=(8,), num_perturbations=8, sigma=0.1,
                      lr=0.2, episode_horizon=16, eval_episodes=2,
                      **train_kw)
            .debugging(seed=0)
            .build(device="cpu"))
    result, best = None, -np.inf
    try:
        for _ in range(iters):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 7.5:
                break
    finally:
        algo.stop()
    return best, result


def test_es_learns_bandit():
    """The reference's gate on the port."""
    from ray_tpu_torch.rllib import ESConfig

    best, result = _run_bandit(ESConfig, l2_coeff=0.0)
    assert best >= 7.5, result
    assert result["timesteps_total"] > 0
    assert result["training_iteration"] >= 1


def test_ars_learns_bandit_with_topk():
    from ray_tpu_torch.rllib import ARSConfig

    best, result = _run_bandit(ARSConfig, top_k=4)
    assert best >= 7.5, result


def test_es_checkpoint_roundtrip():
    from ray_tpu_torch.rllib import ESConfig

    algo = (ESConfig().environment(BANDIT).env_runners(num_env_runners=1)
            .training(hidden=(8,), num_perturbations=4, sigma=0.1,
                      episode_horizon=16, eval_episodes=1)
            .build(device="cpu"))
    try:
        algo.train()
        blob = algo.get_weights()
        theta_before = blob["theta"].copy()
        algo.train()
        assert not np.array_equal(theta_before, algo.theta)
        algo.set_weights(blob)
        assert np.array_equal(theta_before, algo.theta)
        a = algo.compute_single_action(np.array([1.0, -1.0], np.float32))
        assert a in (0, 1)
    finally:
        algo.stop()


# --------------------------------------------------------------- Ape-X

def _q_batch(n, seed, obs_dim=4, action_dim=3):
    rng = np.random.default_rng(seed)
    disc = (0.99 ** rng.integers(1, 4, n)).astype(np.float32)
    disc[rng.random(n) < 0.2] = 0.0
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, action_dim, n).astype(np.int32),
            "rewards": rng.uniform(-1, 2, n).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "discounts": disc}


def test_replay_shard_equals_the_reference():
    from ray_tpu.rllib.apex import ReplayShard as Ref
    from ray_tpu_torch.rllib import ReplayShard

    a, b = Ref(100, 0.6, 0.4, seed=3), ReplayShard(100, 0.6, 0.4, seed=3)
    for s in range(3):
        batch = _q_batch(48, s)
        prios = np.random.default_rng(s).uniform(0.1, 2.0, 48)
        assert a.add(batch, prios) == b.add(batch, prios)
    assert a.size() == b.size() == 100
    assert a.sample(200) is None and b.sample(200) is None
    for _ in range(3):
        x, y = a.sample(32), b.sample(32)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        new = np.abs(np.random.default_rng(7).standard_normal(32)) + 1e-6
        a.update_priorities(x["_indices"], new)
        b.update_priorities(y["_indices"], new)


def _jax_td_abs(model, double_q):
    """apex.py:136-150's initial priority, jitted as the reference jits
    it."""
    def td_abs(params, target_params, batch):
        q = model.apply(params, batch["obs"])
        qa = jnp.take_along_axis(
            q, batch["actions"][:, None].astype(jnp.int32), -1)[:, 0]
        nq_t = model.apply(target_params, batch["next_obs"])
        if double_q:
            sel = model.apply(params, batch["next_obs"]).argmax(axis=-1)
            boot = jnp.take_along_axis(nq_t, sel[:, None], -1)[:, 0]
        else:
            boot = nq_t.max(axis=-1)
        target = batch["rewards"] + batch["discounts"] * boot
        return jnp.abs(qa - target)
    return jax.jit(td_abs)


def _apex_pair(double_q):
    """The port's APEX learner and the JAX DQN update it builds on, the
    port holding JAX's params and a target one Polyak step apart."""
    from ray_tpu.rllib.apex import APEX as JaxAPEX
    from ray_tpu.rllib.apex import APEXConfig as JaxConfig
    from ray_tpu.rllib.dqn import build_q_model
    from ray_tpu_torch.rllib import APEX, APEXConfig

    spec = dict(obs_dim=4, action_dim=3, hidden=(32, 32))
    jcfg = JaxConfig().training(lr=5e-3, batch_size=64, double_q=double_q,
                                model={"hidden": (32, 32)})
    pcfg = APEXConfig().training(lr=5e-3, batch_size=64, double_q=double_q,
                                 model={"hidden": (32, 32)})
    jalgo = JaxAPEX.__new__(JaxAPEX)
    jalgo.config = jcfg
    jalgo.model = build_q_model(spec)
    jalgo.opt = optax.adam(jcfg.train["lr"])
    update = jalgo._build_update()
    params = jalgo.model.init(jax.random.PRNGKey(1))
    target = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.sign(p), params)
    palgo = APEX.learner_only(pcfg, 4, 3, device="cpu")
    palgo.params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            params), "cpu")
    palgo.target_params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, target), "cpu")
    palgo.opt_state = palgo.opt.init([palgo.params[k]
                                      for k in sorted(palgo.params)])
    return (jalgo, update, params, target, jalgo.opt.init(params)), palgo


def _on(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("double_q", [True, False],
                         ids=["double_q", "max_q"])
def test_td_abs_matches_jax(double_q):
    (jalgo, _, params, target, _), palgo = _apex_pair(double_q)
    batch = _q_batch(256, 4)
    want = _jax_td_abs(jalgo.model, double_q)(
        params, target, {k: jnp.asarray(v) for k, v in batch.items()})
    got = palgo._td_abs(palgo.params, palgo.target_params, _on(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("double_q", [True, False],
                         ids=["double_q", "max_q"])
def test_update_on_a_shard_sample_matches_jax(double_q):
    """Insert with |TD| priorities, sample the gate's batch of 64 (PER
    weights), one update on each side within 1e-4, priorities pushed back
    alike, and the next draws equal."""
    from ray_tpu.rllib.apex import ReplayShard as Ref
    from ray_tpu_torch.rllib import ReplayShard

    (jalgo, update, params, target, opt_state), palgo = _apex_pair(double_q)
    batch = _q_batch(256, 5)
    prios = np.asarray(_jax_td_abs(jalgo.model, double_q)(
        params, target, {k: jnp.asarray(v) for k, v in batch.items()}))
    pprios = palgo._td_abs(palgo.params, palgo.target_params,
                           palgo._device_batch(batch)).numpy()
    jshard, pshard = Ref(4096, 0.6, 0.4, seed=0), ReplayShard(4096, 0.6, 0.4,
                                                              seed=0)
    jshard.add(batch, prios + 1e-6)
    pshard.add(batch, pprios + 1e-6)
    js, ps = jshard.sample(64), pshard.sample(64)
    np.testing.assert_array_equal(ps["_indices"], js["_indices"])
    np.testing.assert_allclose(ps["_weights"], js["_weights"], rtol=1e-5)
    jb = {k: jnp.asarray(v) for k, v in js.items()
          if not k.startswith("_")}
    jb["weights"] = jnp.asarray(js["_weights"])
    params, target, opt_state, jloss, jtd = update(params, target,
                                                   opt_state, jb)
    (palgo.params, palgo.target_params, palgo.opt_state, ploss,
     ptd) = palgo._update(palgo.params, palgo.target_params,
                          palgo.opt_state, palgo._device_batch(ps))
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-4,
                               atol=1e-6)
    for k, v in params.items():
        np.testing.assert_allclose(palgo.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(palgo.target_params[k].numpy(),
                                   np.asarray(target[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    jshard.update_priorities(js["_indices"], np.abs(np.asarray(jtd)) + 1e-6)
    pshard.update_priorities(ps["_indices"], ptd.abs().numpy() + 1e-6)
    np.testing.assert_array_equal(pshard.sample(64)["_indices"],
                                  jshard.sample(64)["_indices"])


def test_apex_learns_bandit():
    """The reference's gate (tests/test_rllib_apex.py) on the port: the
    sampler fleet feeds sharded replay, the learner pushes priorities
    back, and the greedy actor reaches the better arm."""
    from ray_tpu_torch.rllib import APEXConfig

    algo = (APEXConfig()
            .environment(BANDIT)
            .env_runners(num_env_runners=2, rollout_steps=128)
            .sharding(num_replay_shards=2)
            .training(lr=5e-3, batch_size=64, train_iters=8, n_step=1,
                      replay=dict(learn_starts=64, capacity=4096))
            .debugging(seed=0)
            .build(device="cpu"))
    eps = algo._actor_eps
    assert len(eps) == 2 and eps[0] > eps[1] > 0.0
    best, result = -np.inf, None
    try:
        for _ in range(25):
            result = algo.train()
            if np.isfinite(result["episode_return_mean"]):
                best = max(best, result["episode_return_mean"])
            if (best >= 6.0 and result["num_updates"] > 0
                    and all(s > 0 for s in result["replay_shard_sizes"])):
                break
    finally:
        algo.stop()
    assert best >= 6.0, result
    assert all(s > 0 for s in result["replay_shard_sizes"]), result
    assert result["num_updates"] > 0
