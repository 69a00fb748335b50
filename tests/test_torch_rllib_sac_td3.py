"""The port's SAC, TD3 and DDPG updates against the JAX package's
(ray_tpu/rllib/sac.py, td3.py, ddpg.py) on the CPU, in f32: JAX's state
(targets and log_alpha included) and batch, JAX's draws fed to the port
through ``sac._normal`` and ``td3._normal``; every state leaf and the
losses within 1e-4."""

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


TOL = dict(rtol=1e-4, atol=1e-5)
OBS, ACT, HID, B = 3, 2, (32, 32), 16


def carry(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def batch(seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((B, OBS)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
            "rewards": rng.standard_normal(B).astype(np.float32),
            "next_obs": rng.standard_normal((B, OBS)).astype(np.float32),
            "dones": (rng.random(B) < 0.25).astype(np.float32)}


def assert_state_close(got, want, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **TOL,
                                   err_msg=f"{what}: {jax.tree_util.keystr(path)}")


def queue(draws):
    """A stand-in for a port draw function that hands out JAX's draws."""
    def draw(gen, shape):
        x = draws.pop(0)
        assert tuple(x.shape) == tuple(shape)
        return x
    return draw


def test_sac_update_matches_jax(monkeypatch):
    from ray_tpu.rllib import sac as jsac
    from ray_tpu_torch.rllib import sac as psac

    cfg_kw = dict(model=dict(hidden=HID), init_alpha=0.3, tau=0.05,
                  actor_lr=1e-3, critic_lr=2e-3, alpha_lr=5e-3)
    jcfg = jsac.SACConfig().training(**cfg_kw)
    pcfg = psac.SACConfig().training(**cfg_kw)
    ja = jsac.SAC.__new__(jsac.SAC)
    ja.config = jcfg
    ja.policy = jsac.SquashedGaussianPolicy(OBS, ACT, HID)
    ja.q1, ja.q2 = jsac.QNetworkSA(OBS, ACT, HID), jsac.QNetworkSA(OBS, ACT,
                                                                   HID)
    ja.target_entropy = -float(ACT)
    ja.opt = {"pi": optax.adam(1e-3), "q": optax.adam(2e-3),
              "alpha": optax.adam(5e-3)}
    jupdate = ja._build_update()
    k = jax.random.split(jax.random.PRNGKey(0), 5)
    state = {"pi": ja.policy.init(k[0]), "q1": ja.q1.init(k[1]),
             "q2": ja.q2.init(k[2]),
             "log_alpha": jnp.asarray(np.log(0.3), jnp.float32),
             "q1_t": ja.q1.init(k[3]), "q2_t": ja.q2.init(k[4])}
    opt_state = {"pi": ja.opt["pi"].init(state["pi"]),
                 "q": ja.opt["q"].init((state["q1"], state["q2"])),
                 "alpha": ja.opt["alpha"].init(state["log_alpha"])}

    port = psac.SAC.learner_only(pcfg, OBS, ACT, device="cpu")
    assert port.target_entropy == ja.target_entropy
    pstate = carry(state)
    popt = port.init_opt_state(pstate)
    draws = []
    monkeypatch.setattr(psac, "_normal", queue(draws))
    for i in range(2):
        b = batch(i)
        key = jax.random.PRNGKey(10 + i)
        k1, k2 = jax.random.split(key)
        draws.extend(torch.from_numpy(np.array(jax.random.normal(kk, (B, ACT))))
                     for kk in (k1, k2))
        state, opt_state, jc, jal, jalpha = jupdate(
            state, opt_state, {kk: jnp.asarray(v) for kk, v in b.items()},
            key)
        pstate, popt, pc, pal, palpha = port._update(
            pstate, popt, {kk: torch.from_numpy(v) for kk, v in b.items()},
            torch.Generator())
        assert not draws
        for name, p, j in (("critic_loss", pc, jc), ("actor_loss", pal, jal),
                           ("alpha", palpha, jalpha)):
            np.testing.assert_allclose(p.item(), float(j), **TOL,
                                       err_msg=f"{name}, update {i}")
        assert_state_close(pstate, state, f"update {i}")


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_td3_and_ddpg_updates_match_jax(algo, monkeypatch):
    """TD3 with do_actor False, then True (smoothing noise on, twin
    critics); DDPG (single critic: q2 only ticks Adam's count) with the
    actor every update."""
    from ray_tpu.rllib import ddpg as jddpg, td3 as jtd3
    from ray_tpu_torch.rllib import ddpg as pddpg, td3 as ptd3

    cfg_kw = dict(model=dict(hidden=HID), tau=0.05, actor_lr=1e-3,
                  critic_lr=2e-3)
    if algo == "td3":
        jcfg, pcfg = (jtd3.TD3Config().training(**cfg_kw),
                      ptd3.TD3Config().training(**cfg_kw))
        do_actor = (False, True, True)
    else:
        jcfg, pcfg = (jddpg.DDPGConfig().training(**cfg_kw),
                      pddpg.DDPGConfig().training(**cfg_kw))
        do_actor = (True, True)
    ja = jtd3.TD3.__new__(jtd3.TD3)
    ja.config = jcfg
    ja.policy = jtd3.DeterministicPolicy(OBS, ACT, HID)
    ja.q1, ja.q2 = jtd3.QNetworkSA(OBS, ACT, HID), jtd3.QNetworkSA(OBS, ACT,
                                                                   HID)
    ja.opt = {"pi": optax.adam(1e-3), "q": optax.adam(2e-3)}
    jupdate = ja._build_update()
    k = jax.random.split(jax.random.PRNGKey(1), 6)
    state = {"pi": ja.policy.init(k[0]), "q1": ja.q1.init(k[1]),
             "q2": ja.q2.init(k[2]), "pi_t": ja.policy.init(k[3]),
             "q1_t": ja.q1.init(k[4]), "q2_t": ja.q2.init(k[5])}
    # a larger actor head, so the target actions reach the [-1, 1] clip
    state["pi_t"] = dict(state["pi_t"], w2=state["pi_t"]["w2"] * 200.0)
    opt_state = {"pi": ja.opt["pi"].init(state["pi"]),
                 "q": ja.opt["q"].init((state["q1"], state["q2"]))}

    port = ptd3.TD3.learner_only(pcfg, OBS, ACT, device="cpu")
    pstate = carry(state)
    popt = port.init_opt_state(pstate)
    draws = []
    monkeypatch.setattr(ptd3, "_normal", queue(draws))
    for i, actor in enumerate(do_actor):
        b = batch(i)
        key = jax.random.PRNGKey(20 + i)
        draws.append(torch.from_numpy(np.array(
            jax.random.normal(key, (B, ACT)))))
        state, opt_state, jc, jal = jupdate(
            state, opt_state, {kk: jnp.asarray(v) for kk, v in b.items()},
            key, do_actor=actor)
        pstate, popt, pc, pal = port._update(
            pstate, popt, {kk: torch.from_numpy(v) for kk, v in b.items()},
            torch.Generator(), actor)
        assert not draws
        np.testing.assert_allclose(pc.item(), float(jc), **TOL,
                                   err_msg=f"critic_loss, update {i}")
        np.testing.assert_allclose(pal.item(), float(jal), **TOL,
                                   err_msg=f"actor_loss, update {i}")
        assert_state_close(pstate, state, f"update {i}")
        assert popt["q"]["count"] == int(opt_state["q"][0].count)
