"""The port's pipeline on a tiny MoE config against the JAX package's, on
pp=2, dp=2: the loss, ``moe_aux_loss`` and every gradient of the total
loss within 1e-4 of JAX's, under GPipe and the interleaved schedule.

Routing is per microbatch and per dp shard in both packages.  GPipe's aux
loss sums the MoE aux of every tick, bubble ticks included, where the
interleaved schedule masks it to the valid residents (ROADMAP C7): with
V=1 the interleaved schedule runs GPipe's ticks with the same routing, so
the two losses agree and the aux losses do not, in JAX and in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpp
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.convert import pp_state_from_numpy
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpp
from ray_tpu_torch.parallel import train_step as tts

TOL = 1e-4
JCFG = jcfg.tiny(vocab=128, layers=4, hidden=32, heads=4, seq=32, experts=4)
# name -> (microbatches, virtual stages, schedule)
CASES = {"gpipe": (2, 1, "gpipe"), "interleaved_v1": (2, 1, "interleaved"),
         "interleaved_v2": (2, 2, "interleaved")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: under the suite's parallel
    workers torch's threads oversubscribe the cores.  No tolerance here
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _batch():
    toks = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (8, JCFG.max_seq_len + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _loss_fns(name, jm, tm, tc):
    m, v, schedule = CASES[name]
    if schedule == "gpipe":
        return (jpp.pipeline_loss_fn(JCFG, jm, m, compute_dtype=jnp.float32,
                                     loss_chunk=None),
                tpp.pipeline_loss_fn(tc, tm, m, compute_dtype=torch.float32,
                                     loss_chunk=None))
    return (jpp.interleaved_pipeline_loss_fn(JCFG, jm, m, v,
                                             compute_dtype=jnp.float32,
                                             loss_chunk=None),
            tpp.interleaved_pipeline_loss_fn(tc, tm, m, v,
                                             compute_dtype=torch.float32,
                                             loss_chunk=None))


def _meshes():
    spec = dict(pp=2, dp=2, fsdp=1)
    return (jmesh.MeshSpec(**spec).build(jax.devices()[:4]),
            tmesh.MeshSpec(**spec).build(["cpu"] * 4))


@pytest.fixture(scope="module")
def runs():
    """Per case: (JAX's (loss, aux, staged grads), the port's)."""
    params = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0),
                                                      JCFG))
    zeros = jax.tree.map(np.zeros_like, params)
    tc = tcfg.TransformerConfig(**dataclasses.asdict(JCFG))
    jm, tm = _meshes()
    batch = _batch()
    out = {}
    for name, (_, v, _) in CASES.items():
        jfn, tfn = _loss_fns(name, jm, tm, tc)
        staged = jpp.partition_layers(jax.tree.map(jnp.asarray, params), 2, v)
        (_, jmet), jg = jax.jit(jax.value_and_grad(
            lambda p: jfn(p, batch), has_aux=True))(staged)
        want = (float(jmet["loss"]), float(jmet["moe_aux_loss"]),
                {k: np.asarray(x) for k, x in _paths(jg)})
        state, _ = pp_state_from_numpy(
            tc, tm, {"params": params, "mu": zeros, "nu": zeros, "count": 0,
                     "step": 0}, virtual_stages=v)
        total, met = tfn(state.params, batch)
        leaves = tts._leaves(state.params)
        got = torch.autograd.grad(total, [p for leaf in leaves
                                          for p in leaf.parts],
                                  allow_unused=True)
        grads, _ = tts._sum_copies(leaves, got, tm.device_list[0])
        tgrads = {path: tmesh.Sharded(g, leaf.sharding).full().numpy()
                  for path, g, leaf in zip(sorted(tts._flat_paths(
                      state.params)), grads, leaves)}
        out[name] = (want, (float(met["loss"].detach()),
                            float(met["moe_aux_loss"].detach()), tgrads))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_pipeline_matches_jax(name, runs):
    (jloss, jaux, jgrads), (tloss, taux, tgrads) = runs[name]
    assert tloss == pytest.approx(jloss, rel=TOL)
    assert taux == pytest.approx(jaux, rel=TOL)
    assert taux > 0
    scale = max(1.0, max(float(np.abs(g).max()) for g in jgrads.values()))
    assert jgrads.keys() == tgrads.keys()
    for path, g in jgrads.items():
        np.testing.assert_allclose(tgrads[path], g, rtol=0, atol=TOL * scale,
                                   err_msg=path)


def test_gpipe_counts_the_bubble_ticks_aux(runs):
    """C7: GPipe and the interleaved schedule at V=1 run the same ticks and
    route the same microbatches, so their losses agree; GPipe's aux also
    sums the bubble ticks', the interleaved schedule's does not."""
    (g_loss, g_aux, _), (tg_loss, tg_aux, _) = runs["gpipe"]
    (i_loss, i_aux, _), (ti_loss, ti_aux, _) = runs["interleaved_v1"]
    assert g_loss == pytest.approx(i_loss, rel=1e-6)
    assert tg_loss == pytest.approx(ti_loss, rel=1e-6)
    assert g_aux > i_aux + 0.1 and tg_aux > ti_aux + 0.1
