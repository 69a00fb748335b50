"""The port's ring and Ulysses attention and its sp train step against the
JAX package's, on the same numpy inputs.

JAX runs on the 8 virtual CPU devices of tests/conftest.py, the port on
``["cpu"] * n``.  Attention within 2e-5 (tests/test_models_parallel.py's
shapes: dp=2, sp=4, GQA), gradients through the ring within 1e-4 of plain
attention's, and three train steps on dp=2, sp=4 (and a tiny MoE config
on dp=2, sp=2, whose routing order is the batch's token order) within
1e-4 of JAX's, loss and every leaf.  JAX's steps are computed once per
module.  A head dim of 64 sends the ring through the kernels' plain
versions (CPU tensors), 16 through the recurrence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import ring_attention as jring
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import train_step as jts
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.convert import sharded_state_from_numpy
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import ring_attention as tring
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts

ATTN_TOL, STEP_TOL = 2e-5, 1e-4
OPT = dict(learning_rate=3e-4, warmup_steps=1, total_steps=8, grad_clip=6.5)
STEPS = 3
# the train steps: (config, mesh, sp_axis)
STEP_CASES = {
    "sp_axis": (jcfg.tiny(seq=64), dict(dp=2, sp=4), "sp"),
    "sp_axis_none": (jcfg.tiny(seq=64), dict(dp=2, sp=4), None),
    "moe": (jcfg.tiny(seq=64, experts=4), dict(dp=2, sp=2), "sp"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: under the suite's parallel
    workers torch's threads oversubscribe the cores.  No tolerance here
    depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(spec):
    n = int(np.prod(list(spec.values())))
    return (jmesh.MeshSpec(fsdp=1, **spec).build(jax.devices()[:n]),
            tmesh.MeshSpec(fsdp=1, **spec).build(["cpu"] * n))


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv)]


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# The recurrence, the ring, Ulysses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 0.0),
                                            (True, 20.0)])
def test_attend_blockwise_matches_jax(causal, softcap):
    q, k, v = _qkv(0, 2, 8, 4, 2, 16)
    k2, v2 = _qkv(1, 2, 8, 4, 2, 16)[1:]
    jstate = (jnp.full((2, 4, 8), -jnp.inf), jnp.zeros((2, 4, 8)),
              jnp.zeros((2, 8, 4, 16)))
    tstate = (torch.full((2, 4, 8), float("-inf")), torch.zeros(2, 4, 8),
              torch.zeros(2, 8, 4, 16))
    # q holds positions 8..15: the first block (0..7) whole, the second
    # (8..15) on its diagonal
    for kb, vb, off in ((k, v, 0), (k2, v2, 8)):
        jstate = jattn.attend_blockwise(q, kb, vb, *jstate, causal=causal,
                                        q_offset=8, kv_offset=off,
                                        logit_softcap=softcap)
        tstate = tattn.attend_blockwise(
            torch.from_numpy(q), torch.from_numpy(kb), torch.from_numpy(vb),
            *tstate, causal=causal, q_offset=8, kv_offset=off,
            logit_softcap=softcap)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATTN_TOL)
    np.testing.assert_allclose(
        tattn.finalize_blockwise(*tstate).numpy(),
        np.asarray(jattn.finalize_blockwise(*jstate)), rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("kind,heads,softcap", [
    ("ring", (4, 2), 0.0), ("ring", (4, 2), 20.0), ("ulysses", (8, 4), 0.0),
    ("ulysses", (4, 2), 0.0)])
def test_ring_and_ulysses_match_jax(kind, heads, softcap):
    """tests/test_models_parallel.py:87-110's shapes; Ulysses with 2 KV
    heads on sp=4 is the ring, as in the reference."""
    jm, tm = _meshes(dict(dp=2, sp=4))
    q, k, v = _qkv(2, 2, 32, *heads, 16)
    if kind == "ring":
        want = jax.jit(lambda q, k, v: jring.ring_attention(
            q, k, v, jm, "sp", batch_axes=("dp",),
            logit_softcap=softcap))(q, k, v)
        got = tring.ring_attention(*map(torch.from_numpy, (q, k, v)), tm,
                                   "sp", batch_axes=("dp",),
                                   logit_softcap=softcap)
    else:
        want = jax.jit(lambda q, k, v: jring.ulysses_attention(
            q, k, v, jm, "sp", batch_axes=("dp",)))(q, k, v)
        got = tring.ulysses_attention(*map(torch.from_numpy, (q, k, v)), tm,
                                      "sp", batch_axes=("dp",))
    assert tuple(got.sharding.spec) == (("dp",), "sp")
    np.testing.assert_allclose(got.full().numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("d,causal", [(16, True), (64, True), (64, False)])
def test_ring_gradients_match_plain_attention(d, causal):
    """q, k and v gradients of the ring (the recurrence at D=16, the
    kernels' plain versions at D=64) against plain attention's."""
    _, tm = _meshes(dict(dp=2, sp=4))
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(3, 2, 32, 4, 2, d))
    g = torch.from_numpy(_qkv(4, 2, 32, 4, 2, d)[0])
    assert tring.ring_kernel_takes(False, d, 0.0, torch.float32) == (d == 64)
    want = torch.autograd.grad(
        (tattn.attend(q, k, v, causal=causal) * g).sum(), (q, k, v))
    out = tring.ring_attention(q, k, v, tm, "sp", causal=causal,
                               batch_axes=("dp",))
    loss = sum((p * g[sl]).sum() for p, sl in
               zip(out.parts, out.sharding.slices(g.shape)))
    got = torch.autograd.grad(loss, (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=STEP_TOL)
    # a rerun gives the same bits
    again = tring.ring_attention(q, k, v, tm, "sp", causal=causal,
                                 batch_axes=("dp",))
    assert all(torch.equal(a, b) for a, b in zip(again.parts, out.parts))


# ---------------------------------------------------------------------------
# The sp train step
# ---------------------------------------------------------------------------

def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (4, cfg.max_seq_len + 1)
                            ).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _jax_run(name):
    """JAX's state before the steps (numpy), each step's metrics and the
    state after them."""
    cfg, spec, sp_axis = STEP_CASES[name]
    jm, _ = _meshes(spec)
    opt = jts.make_optimizer(**OPT)
    params = jtr.init_params(jax.random.PRNGKey(0), cfg)
    state = jts.TrainState(params=params, opt_state=opt.init(params),
                           step=jnp.zeros((), jnp.int32))
    sh = jts.state_shardings(cfg, jm, opt, state)
    start = jax.tree.map(np.asarray, state)
    state = jax.device_put(state, sh)
    step = jts.make_train_step(cfg, jm, opt, sh, compute_dtype=jnp.float32,
                               sp_axis=sp_axis)
    metrics = []
    for b in _batches(cfg, 5):
        state, m = step(state, b)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "moe_aux_loss")})
    return start, metrics, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_run(name) for name in STEP_CASES}


def _port_state(cfg, tm, jstate):
    adam = jstate.opt_state[1][0]
    return sharded_state_from_numpy(
        jstate.params, adam.mu, adam.nu, adam.count, jstate.step,
        tts.state_shardings(cfg, tm))


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sp_train_steps_match_jax(name, jax_runs):
    jcfg_, spec, sp_axis = STEP_CASES[name]
    start, jmetrics, jend = jax_runs[name]
    cfg = tcfg.TransformerConfig(**dataclasses.asdict(jcfg_))
    _, tm = _meshes(spec)
    state = _port_state(cfg, tm, start)
    step = tts.make_train_step(cfg, tm, tts.make_optimizer(**OPT), None,
                               compute_dtype=torch.float32, sp_axis=sp_axis)
    assert step.batch_sharding.spec == tmesh.PartitionSpec(("dp", "fsdp"),
                                                            "sp")
    for b, jm_ in zip(_batches(jcfg_, 5), jmetrics):
        state, m = step(state, b)
        for key, want in jm_.items():
            assert float(m[key]) == pytest.approx(want, rel=STEP_TOL,
                                                  abs=STEP_TOL), key
    adam = jend.opt_state[1][0]
    for tree, want in ((state.params, jend.params),
                       (state.opt_state["mu"], adam.mu),
                       (state.opt_state["nu"], adam.nu)):
        w = dict(_paths(want))
        scale = max(float(np.abs(x).max()) for x in w.values())
        for path, leaf in _paths(tree):
            np.testing.assert_allclose(
                leaf.full().numpy(), w[path], rtol=0,
                atol=STEP_TOL * max(scale, 1.0) if tree is not state.params
                else STEP_TOL, err_msg=path)


def test_sp_eval_step_matches_the_whole_batch_loss(jax_runs):
    """``make_eval_step`` on dp=2, sp=4 against JAX's loss of the whole
    batch on one device (the reference's eval step puts only ``tokens``
    on the mesh, which sp cannot cut into a shifted pair)."""
    jcfg_, spec, _ = STEP_CASES["sp_axis"]
    start = jax_runs["sp_axis"][0]
    cfg = tcfg.TransformerConfig(**dataclasses.asdict(jcfg_))
    _, tm = _meshes(spec)
    state = _port_state(cfg, tm, start)
    batch = _batches(jcfg_, 6)[0]
    want, _ = jtr.causal_lm_loss(start.params, batch, jcfg_,
                                 compute_dtype=jnp.float32)
    got = tts.make_eval_step(cfg, tm, None, compute_dtype=torch.float32,
                             sp_axis="sp")(state.params, batch)
    assert float(got["loss"]) == pytest.approx(float(want), rel=STEP_TOL)
    assert int(got["tokens"]) == batch["targets"].size
    # a [B, S+1] batch is shifted before it is cut, as the whole batch is
    whole = {"tokens": np.concatenate([batch["tokens"],
                                       batch["targets"][:, -1:]], 1)}
    again = tts.make_eval_step(cfg, tm, None, compute_dtype=torch.float32,
                               sp_axis="sp")(state.params, whole)
    assert float(again["loss"]) == float(got["loss"])
