"""The port's offline RL (ray_tpu_torch/rllib/offline.py) against the JAX
package's (ray_tpu/rllib/offline.py) on the CPU: the episode IO and the
datasets equal, then MARWIL (beta=1), BC and CQL's loss, gradients and a
whole ``train()`` of 10 updates from JAX's params carried over, within
1e-4 (the minibatch draws are the same numpy generator's); and the
reference's learning gates on the port."""

import json

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


TOL = dict(rtol=1e-4, atol=1e-5)


def _expert(obs):
    """The reference's scripted CartPole expert (tests/test_rllib_offline.py):
    push toward the falling side."""
    return int(obs[2] + 0.5 * obs[3] > 0)


def _noisy(obs):
    """The expert, flipped on a fifth of the states (a mixed-quality
    corpus, so the advantage weights differ from 1)."""
    a = _expert(obs)
    return 1 - a if abs(int(obs[0] * 1e6)) % 5 == 0 else a


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from ray_tpu_torch.rllib import collect_episodes
    path = str(tmp_path_factory.mktemp("offline") / "expert.jsonl")
    collect_episodes("CartPole-v1", _expert, 30, path=path)
    return path


@pytest.fixture(scope="module")
def mixed_corpus(tmp_path_factory):
    from ray_tpu_torch.rllib import collect_episodes
    path = str(tmp_path_factory.mktemp("offline") / "mixed.jsonl")
    collect_episodes("CartPole-v1", _noisy, 12, path=path, seed=100)
    return path


def closure(jitted, name):
    """A variable of a jitted function's closure (the reference builds its
    loss inside ``__init__``)."""
    fn = jitted.__wrapped__
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


# ------------------------------------------------------------- datasets

def test_episode_io_equals_the_reference(tmp_path):
    from ray_tpu.rllib import offline as ref
    from ray_tpu_torch.rllib import offline as port

    paths = {}
    for name, mod in (("ref", ref), ("port", port)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        eps = mod.collect_episodes("CartPole-v1", _noisy, 4,
                                   path=paths[name], seed=7)
        assert len(eps) == 4
    ref_lines = open(paths["ref"]).read()
    assert ref_lines == open(paths["port"]).read()
    assert len(ref_lines.splitlines()) == 4
    # write_episodes appends
    port.write_episodes(paths["port"], [json.loads(ref_lines.splitlines()[0])])
    assert len(open(paths["port"]).read().splitlines()) == 5


@pytest.mark.parametrize("gamma", [1.0, 0.97])
def test_datasets_equal_the_reference(corpus, gamma):
    from ray_tpu.rllib import offline as ref
    from ray_tpu_torch.rllib import offline as port

    a = ref.OfflineDataset.from_jsonl(corpus, gamma=gamma)
    b = port.OfflineDataset.from_jsonl(corpus, gamma=gamma)
    assert len(a) == len(b) > 3000
    for k in ("obs", "actions", "returns"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), k)
        assert getattr(b, k).dtype == getattr(a, k).dtype, k
    ta = ref.TransitionDataset.from_jsonl(corpus)
    tb = port.TransitionDataset.from_jsonl(corpus)
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(ta, k), k)
    # the reference's own checks: one terminal per episode, next_obs shifts
    assert tb.dones.sum() == 30
    i = int(np.flatnonzero(tb.dones == 0)[0])
    assert np.allclose(tb.next_obs[i], tb.obs[i + 1])


# ------------------------------------------------------------- learners

def _pair(kind, path, **train):
    """The reference's learner and the port's on the same corpus and
    config, the port holding JAX's params and a fresh optimizer."""
    import ray_tpu.rllib as ref
    import ray_tpu_torch.rllib as port

    cfg_name = {"marwil": "MARWILConfig", "bc": "BCConfig",
                "cql": "CQLConfig"}[kind]
    train = dict(dict(hidden=(32, 32), train_batch_size=64,
                      updates_per_iter=10, lr=3e-3, seed=3), **train)
    if kind == "cql":
        train.setdefault("target_update_every", 4)
    jalgo = (getattr(ref, cfg_name)().environment("CartPole-v1")
             .offline_data(path).training(**train).build())
    palgo = (getattr(port, cfg_name)().environment("CartPole-v1")
             .offline_data(path).training(**train).build(device="cpu"))
    palgo.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jalgo.params.items()}, "cpu")
    palgo.opt_state = palgo.opt.init([palgo.params[k]
                                      for k in sorted(palgo.params)])
    if kind == "cql":
        palgo.target_params = {k: v.clone() for k, v in palgo.params.items()}
    return jalgo, palgo


def _minibatch(algo, fields, n=64, seed=11):
    idx = np.random.default_rng(seed).integers(0, len(algo.data), n)
    return {f: getattr(algo.data, f)[idx] for f in fields}


@pytest.mark.parametrize("kind", ["marwil", "bc", "cql"])
def test_loss_and_grads_match_jax(kind, corpus, mixed_corpus):
    jalgo, palgo = _pair(kind, mixed_corpus if kind == "marwil" else corpus)
    fields = palgo._fields
    mb = _minibatch(palgo, fields)
    loss_fn = closure(jalgo._update, "loss_fn")
    args = [jnp.asarray(mb[f]) for f in fields]
    if kind == "cql":
        args = [jalgo.target_params] + args
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jalgo.params, *args)
    keys = sorted(palgo.params)
    p = {k: palgo.params[k].detach().requires_grad_() for k in keys}
    ploss, paux = palgo._loss(p, {f: torch.from_numpy(mb[f])
                                  for f in fields})
    grads = torch.autograd.grad(ploss, [p[k] for k in keys],
                                allow_unused=True)
    np.testing.assert_allclose(ploss.item(), float(jloss), **TOL)
    for got, want in zip(paux, jaux):
        np.testing.assert_allclose(got.item(), float(want), **TOL)
    for k, g in zip(keys, grads):
        want = np.asarray(jgrads[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["marwil", "bc", "cql"])
def test_train_matches_jax(kind, corpus, mixed_corpus):
    """A whole train(): 10 updates on the same numpy draws (CQL's target
    copied every 4), the metrics and every leaf within 1e-4."""
    jalgo, palgo = _pair(kind, mixed_corpus if kind == "marwil" else corpus)
    jm, pm = jalgo.train(), palgo.train()
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], **TOL, err_msg=k)
    pw = palgo.get_weights()
    for k, v in jalgo.params.items():
        np.testing.assert_allclose(pw[k], np.asarray(v), **TOL, err_msg=k)
    if kind == "cql":
        assert palgo._updates == 10
        for k, v in jalgo.target_params.items():
            np.testing.assert_allclose(palgo.target_params[k].numpy(),
                                       np.asarray(v), **TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["marwil", "cql"])
def test_learner_only_equals_the_driver(kind, corpus):
    """``learner_only`` (no env, no gymnasium) builds the driver's learner
    from the sizes and a dataset."""
    import ray_tpu_torch.rllib as port

    cls, cfg_cls, ds = {
        "marwil": (port.MARWIL, port.MARWILConfig, port.OfflineDataset),
        "cql": (port.CQL, port.CQLConfig, port.TransitionDataset)}[kind]
    cfg = (cfg_cls().environment("CartPole-v1").offline_data(corpus)
           .training(hidden=(16,), updates_per_iter=3, seed=2))
    driver = cfg.build(device="cpu")
    alone = cls.learner_only(cfg, 4, 2, device="cpu",
                             data=ds.from_jsonl(corpus))
    assert driver.train() == alone.train()


# ---------------------------------------------------------- the gates

def test_bc_clones_expert(corpus):
    """The reference's gate (tests/test_rllib_offline.py) on the port."""
    from ray_tpu_torch.rllib import BCConfig

    algo = (BCConfig().environment("CartPole-v1").offline_data(corpus)
            .training(lr=3e-3, updates_per_iter=100, seed=0)
            .build(device="cpu"))
    for _ in range(5):
        m = algo.train()
    score = algo.evaluate(num_episodes=5)
    assert score > 120, (score, m)


def test_cql_learns_from_expert_corpus(corpus):
    """The reference's CQL gate on the port (its configuration and bars)."""
    from ray_tpu_torch.rllib import CQLConfig

    algo = (CQLConfig().environment("CartPole-v1").offline_data(corpus)
            .training(lr=1e-3, updates_per_iter=150, cql_alpha=2.0, seed=0)
            .build(device="cpu"))
    for _ in range(5):
        m = algo.train()
    assert m["cql_gap"] < 1.0, m
    score = algo.evaluate(num_episodes=5)
    assert score > 100, (score, m)
