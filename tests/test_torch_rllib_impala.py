"""The port's IMPALA / APPO (ray_tpu_torch/rllib/impala.py) against the
JAX package's (ray_tpu/rllib/impala.py) on the CPU, in f32: V-trace's
targets and corrected advantages against the reference's reverse scan
within 1e-6, the loss, its gradients and one update (IMPALA and APPO)
from JAX's params within 1e-4, the dp split against one device within
2e-4, and the driver's stale fragments, its runners actors of the port's
runtime; then APPO's run (the reference's tier-1 test)."""

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
DP_TOL = dict(rtol=2e-4, atol=2e-5)
CFG = {"lr": 5e-3, "gamma": 0.97, "grad_clip": 40.0, "vf_loss_coeff": 0.5,
       "entropy_coeff": 0.01, "vtrace_rho_clip": 1.0, "vtrace_c_clip": 0.9,
       "clip_param": 0.3}


def fragment(jm, jparams, T=16, B=4, seed=0):
    """A fragment at the runner's layout; the behaviour logp is JAX's
    policy's plus noise, so some importance weights clip and some not."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, 4)).astype(np.float32)
    actions = rng.integers(0, 2, (T, B)).astype(np.float32)
    pi, _ = jm.apply(jparams, jnp.asarray(obs.reshape(T * B, 4)))
    logp = np.asarray(jm.log_prob(pi, jnp.asarray(actions.reshape(-1))))
    return {"obs": obs, "actions": actions,
            "logp": (logp.reshape(T, B)
                     + 0.3 * rng.standard_normal((T, B))).astype(np.float32),
            "values": rng.standard_normal((T, B)).astype(np.float32),
            "rewards": rng.standard_normal((T, B)).astype(np.float32),
            "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
            "last_values": rng.standard_normal(B).astype(np.float32)}


def learners(cfg, seed=0, mesh=None):
    """JAX's ImpalaLearner and the port's holding its params."""
    from ray_tpu.rllib.impala import ImpalaLearner as JaxImpala
    from ray_tpu.rllib.models import ActorCriticMLP as JaxMLP
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    jm = JaxMLP(4, 2, (16, 16))
    jl = JaxImpala(jm, cfg, seed=seed)
    pl = ImpalaLearner(ActorCriticMLP(4, 2, (16, 16)), cfg, mesh=mesh,
                       device="cpu")
    pl.params = params_from_numpy({k: np.asarray(v) for k, v in
                                   jl.params.items()}, "cpu")
    pl.opt_state = pl.opt.init(plearner.leaves(pl.params))
    return jm, jl, pl


def jax_vtrace(cfg, tgt_logp, behavior_logp, v, rew, dones, last_values):
    """The reference's V-trace (ray_tpu/rllib/impala.py:132-158) as a
    function: (vs, pg_adv)."""
    gamma = cfg["gamma"]
    rho = jnp.exp(tgt_logp - behavior_logp)
    rho_cl = jnp.minimum(rho, cfg["vtrace_rho_clip"])
    c_cl = jnp.minimum(rho, cfg["vtrace_c_clip"])
    nt = 1.0 - dones
    v_next = jnp.concatenate([v[1:], last_values[None]], 0)
    delta = rho_cl * (rew + gamma * nt * v_next - v)

    def vs_step(acc, xs):
        d, c, n = xs
        acc = d + gamma * n * c * acc
        return acc, acc

    _, vs_minus_v = jax.lax.scan(vs_step, jnp.zeros_like(last_values),
                                 (delta, c_cl, nt), reverse=True)
    vs = vs_minus_v + v
    vs_next = jnp.concatenate([vs[1:], last_values[None]], 0)
    return vs, rho_cl * (rew + gamma * nt * vs_next - v)


def test_vtrace_matches_jax():
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    rng = np.random.default_rng(3)
    T, B = 64, 5
    x = {"tgt": rng.standard_normal((T, B)) * 0.5 - 0.7,
         "beh": rng.standard_normal((T, B)) * 0.5 - 0.7,
         "v": rng.standard_normal((T, B)),
         "rew": rng.standard_normal((T, B)),
         "dones": (rng.random((T, B)) < 0.1) * 1.0,
         "last": rng.standard_normal(B)}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    want = jax.jit(lambda *a: jax_vtrace(CFG, *a))(
        *(jnp.asarray(x[k]) for k in ("tgt", "beh", "v", "rew", "dones",
                                      "last")))
    pl = ImpalaLearner(ActorCriticMLP(4, 2), CFG, device="cpu")
    vs, pg_adv, rho = pl.vtrace(*(torch.from_numpy(x[k]) for k in (
        "tgt", "beh", "v", "rew", "dones", "last")))
    rho_np = np.exp(x["tgt"] - x["beh"])
    assert (rho_np > 1).any() and (rho_np < 0.9).any()   # both clips bind
    np.testing.assert_allclose(vs.numpy(), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pg_adv.numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("appo", [False, True], ids=["impala", "appo"])
def test_loss_and_grads_match_jax(appo):
    cfg = dict(CFG, use_appo_clip=appo)
    jm, jl, pl = learners(cfg)
    r = fragment(jm, jl.params)
    fn = jl._update_fn.__wrapped__
    loss_fn = dict(zip(fn.__code__.co_freevars,
                       (c.cell_contents for c in fn.__closure__)))["loss_fn"]
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jl.params, {k: jnp.asarray(v)
                                            for k, v in r.items()})
    keys = sorted(pl.params)
    p = {k: pl.params[k].detach().requires_grad_() for k in keys}
    ploss, paux = pl._loss(p, {k: torch.from_numpy(v) for k, v in r.items()})
    grads = dict(zip(keys, torch.autograd.grad(ploss, [p[k] for k in keys])))
    np.testing.assert_allclose(ploss.item(), float(jloss), **TOL)
    assert set(paux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(paux[k].item(), float(jaux[k]), **TOL,
                                   err_msg=k)
    for k in jgrads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("appo", [False, True], ids=["impala", "appo"])
def test_updates_match_jax(appo):
    """Two updates on two fragments (the clip by global norm and Adam):
    the metrics and every leaf within 1e-4."""
    cfg = dict(CFG, use_appo_clip=appo)
    jm, jl, pl = learners(cfg, seed=4)
    for step in range(2):
        r = fragment(jm, jl.params, seed=step)
        jmetrics, pmetrics = jl.update(r), pl.update(r)
        assert set(pmetrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(pmetrics[k], jmetrics[k], **TOL,
                                       err_msg=k)
        jw, pw = jl.get_weights(), pl.get_weights()
        for k in jw:
            np.testing.assert_allclose(pw[k], jw[k], **TOL,
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("appo", [False, True], ids=["impala", "appo"])
def test_dp_split_matches_one_device(appo):
    """num_devices_per_learner=2: the columns split over two CPU devices,
    sums divided by the global T·B, against one device."""
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    cfg = dict(CFG, use_appo_clip=appo)
    jm, jl, _ = learners(cfg)
    one = ImpalaLearner(ActorCriticMLP(4, 2, (16, 16)), cfg, seed=5,
                        device="cpu")
    two = ImpalaLearner(ActorCriticMLP(4, 2, (16, 16)), cfg, seed=5,
                        mesh=plearner.dp_mesh(2, "cpu"))
    assert len(two.devices) == 2
    for step in range(2):
        r = fragment(jm, jl.params, T=16, B=8, seed=10 + step)
        m1, m2 = one.update(r), two.update(r)
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], **DP_TOL, err_msg=k)
    w1, w2 = one.get_weights(), two.get_weights()
    for k in w1:
        np.testing.assert_allclose(w2[k], w1[k], **DP_TOL, err_msg=k)


def test_driver_samples_under_stale_snapshots(monkeypatch):
    """Two runner actors, broadcast every update, each update on the first
    fragment to land: each consumed fragment was sampled under the snapshot
    of the version its runner was submitted with, ``lag`` versions behind
    the learner's, 0 <= lag <= num_env_runners."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(lr=5e-3, updates_per_iter=3,
                      model={"hidden": (16, 16)})
            .debugging(seed=0).build(device="cpu"))
    #: the blob each submitted fragment is sampled under, by its ref
    submitted_under = {}
    #: per consumed fragment: its ref, and the learner's weights then
    consumed, now = [], []
    submit = algo._submit

    def recording_submit(runner):
        submit(runner)
        ref = list(algo._in_flight)[-1]
        submitted_under[ref] = ray_tpu_torch.get(algo._weights_ref)

    class Recording(dict):
        def pop(self, ref, *default):
            consumed.append(ref)
            now.append(algo.learner.get_weights())
            return super().pop(ref, *default)

    monkeypatch.setattr(algo, "_submit", recording_submit)
    algo._in_flight = Recording()
    try:
        # the runners' processes up before the first fragment is timed
        ray_tpu_torch.get([r.ping.remote() for r in algo.runners],
                          timeout=60)
        for _ in range(2):
            res = algo.train()
    finally:
        algo.stop()
    lags = algo.version_lags
    assert len(lags) == 6 and all(0 <= lag <= 2 for lag in lags), lags
    assert np.isfinite(res["mean_version_lag"])
    assert res["mean_version_lag"] == pytest.approx(np.mean(lags))
    assert res["num_env_steps_sampled"] == 2 * 3 * 16 * 2
    sampled = [submitted_under[ref] for ref in consumed]
    for k, lag in enumerate(lags):
        # consumed at version k, sampled under version k - lag's snapshot
        for n in sampled[k]:
            np.testing.assert_array_equal(sampled[k][n], now[k - lag][n])
        if lag:
            assert any(not np.array_equal(sampled[k][n], now[k][n])
                       for n in sampled[k]), k


def test_appo_clipped_surrogate_runs():
    """The reference's tier-1 APPO test on the port."""
    from ray_tpu_torch.rllib import APPOConfig

    algo = (APPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(lr=5e-3, updates_per_iter=3)
            .build(device="cpu"))
    try:
        r1 = algo.train()
        r2 = algo.train()
        assert np.isfinite(r2["policy_loss"])
        assert r2["num_env_steps_sampled"] > r1["num_env_steps_sampled"] > 0
    finally:
        algo.stop()


def test_learners_ge_1_raises():
    """num_learners >= 1 builds the learner actors; a fragment whose env
    axis does not split over their dp shards raises the reference's
    divisibility error."""
    from ray_tpu_torch.rllib import IMPALAConfig
    from ray_tpu_torch.rllib.learner_group import DistributedLearnerGroup

    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=1,
                         rollout_fragment_length=8)
            .learners(num_learners=2).build(device="cpu"))
    try:
        assert isinstance(algo.learner, DistributedLearnerGroup)
        assert algo.learner.info["num_processes"] == 2
        with pytest.raises(ValueError, match="not divisible by the dp mesh"):
            algo.train()
    finally:
        algo.stop()
