"""The port's MoE model (``tiny(experts=4)``: 4 experts, top 2) against the
JAX package's, in float32 on the same params and inputs.

* The loss, the aux loss and every gradient within 1e-4 under each remat
  policy; every policy replays the MoE step once per layer in the
  backward (its residuals carry no names).
* Ten optimizer steps within 1e-4.
* ``params_from_numpy`` carries the ``moe`` leaves.
* Greedy streams and ``breakdown()`` of the dense, paged, paged with a
  prefix hit, and speculative engines identical to the JAX engine's in the
  same mode.  Expert capacity comes from every row of a call's batch
  (admit padding rows, bucket padding, the scratch slot, inactive slots'
  last tokens, the verify window), so each mode must fill those rows as the
  JAX engine does; tokens are dropped in these runs.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import MeshSpec
from ray_tpu.parallel import train_step as jts
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import remat as rm
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import (params_from_numpy,
                                          train_state_from_numpy)
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.serve import llm as tllm

JC = jcfg.tiny(experts=4)
TC = tcfg.TransformerConfig(**dataclasses.asdict(JC))


@pytest.fixture(scope="module")
def moe_params():
    params = jtr.init_params(jax.random.PRNGKey(0), JC, dtype=jnp.float32)
    return params, jax.tree.map(np.asarray, params)


def _batch(b=2, s=32, seed=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, JC.vocab_size, (b, s + 1))
            .astype(np.int32)}


@pytest.mark.parametrize("remat", [False, "full", "save_acts", "save_mlp",
                                   "dots"])
def test_moe_loss_and_grads_match_jax(moe_params, remat):
    params, tree = moe_params
    batch = _batch()

    def f(p):
        return jtr.causal_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, JC,
                                  compute_dtype=jnp.float32, remat=remat)

    (jl, jm), jg = jax.value_and_grad(f, has_aux=True)(params)
    p = params_from_numpy(tree, "cpu")
    leaves = tts._leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    rm.replays.clear()
    tl, tm = ttr.causal_lm_loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, TC,
        compute_dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(tl, leaves)
    aux = float(tm["moe_aux_loss"].detach())
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert aux == pytest.approx(float(jm["moe_aux_loss"]), rel=1e-5)
    assert aux > 0
    jleaves = tts._leaves(jax.tree.map(np.asarray, jg))
    assert len(jleaves) == len(grads)
    for a, b in zip(grads, jleaves):
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max() + 1e-8
    assert rm.replays["moe"] == (TC.num_layers if remat else 0)


def test_ten_moe_train_steps_match_jax():
    """Ten fp32 steps of make_train_step (remat on) from the same state and
    batches: loss, aux loss, grad norm and params within 1e-4."""
    opt_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                  grad_clip=10.0)
    mesh = MeshSpec(fsdp=1).build(jax.devices()[:1])
    jopt = jts.make_optimizer(**opt_kw)
    jstate, sh = jts.init_sharded_state(JC, mesh, jopt, seed=0)
    adam = jstate.opt_state[1][0]
    tstate = train_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        np.asarray(adam.count), np.asarray(jstate.step), "cpu")
    assert "moe" in tstate.params["blocks"]
    jstep = jts.make_train_step(JC, mesh, jopt, sh,
                                compute_dtype=jnp.float32)
    tstep = tts.make_train_step(TC, None, tts.make_optimizer(**opt_kw), None,
                                compute_dtype=torch.float32, device="cpu")
    for i in range(10):
        batch = _batch(b=4, seed=10 + i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "moe_aux_loss", "total_loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4)
    jparams = tts._leaves(jax.tree.map(np.asarray, jstate.params))
    for a, b in zip(tts._leaves(tstate.params), jparams):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4)


def test_convert_carries_the_moe_leaves(moe_params):
    """``params_from_numpy`` carries the ``moe`` leaves, and the sliced
    draft of speculative decoding takes their leading layers as it takes
    every stacked leaf."""
    from ray_tpu_torch.models.speculative import make_draft_params
    _, tree = moe_params
    p = params_from_numpy(tree, "cpu")
    assert "mlp" not in p["blocks"]
    assert sorted(p["blocks"]["moe"]) == ["router", "w_gate", "w_in",
                                          "w_out"]
    for k, v in tree["blocks"]["moe"].items():
        np.testing.assert_array_equal(p["blocks"]["moe"][k].numpy(), v)
    half = params_from_numpy(tree, "cpu", torch.bfloat16)
    assert half["blocks"]["moe"]["w_out"].dtype == torch.bfloat16
    draft = make_draft_params(p, 1)["blocks"]["moe"]
    for k, v in p["blocks"]["moe"].items():
        assert torch.equal(draft[k], v[:1])


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 9, 20, 40)
MAX_TOKENS = 8
PAGED = dict(paged=True, page_size=8)
# a fixed k: the adaptive controller would compile one JAX program per k
SPEC = dict(spec_decode_enabled=True, spec_k=4, spec_draft_layers=1,
            spec_adaptive=False)
ARMS = {"dense": {}, "paged": PAGED, "paged_prefix": PAGED, "spec": SPEC,
        "paged_spec": dict(PAGED, **SPEC)}


def _waves(arm):
    """One wave of four prompts (three in bucket 32, one in 64); for the
    prefix arm two waves of two prompts sharing a 24-token (three-page)
    prefix, the second wave hitting the prefix cache."""
    rng = np.random.default_rng(3)
    if arm != "paged_prefix":
        return [[rng.integers(1, JC.vocab_size, n).tolist()
                 for n in PROMPT_LENS]]
    prefix = rng.integers(1, JC.vocab_size, 24).tolist()
    return [[prefix + rng.integers(1, JC.vocab_size, n).tolist()
             for n in (3, 6)] for _ in range(2)]


def _run(eng, mod, prompts, timeout=120.0):
    """Queue every request at once (one admit pass sees them all), then
    collect each stream."""
    reqs = [mod.GenRequest(list(p), MAX_TOKENS, 0.0, 0, None)
            for p in prompts]
    with eng._pending.mutex:
        eng._pending.queue.extend(reqs)
    eng._wake.set()
    outs = []
    deadline = time.monotonic() + timeout
    for r in reqs:
        toks = []
        while True:
            item = r.out.get(timeout=max(0.1, deadline - time.monotonic()))
            if item is mod._FLUSH:
                break
            if isinstance(item, BaseException):
                raise item
            toks.append(item)
        outs.append(toks)
    return outs


@pytest.fixture(scope="module", params=sorted(ARMS))
def jax_streams(request, moe_params):
    """The JAX engine's streams and breakdown in one mode."""
    params, _ = moe_params
    arm = request.param
    eng = jllm.LLMEngine(JC, params, num_slots=4, max_len=64,
                         compute_dtype=jnp.float32, **ARMS[arm])
    try:
        outs = [_run(eng, jllm, w) for w in _waves(arm)]
        return arm, outs, eng.breakdown()
    finally:
        eng.shutdown()


def test_moe_engine_streams_match_jax(jax_streams, moe_params, monkeypatch):
    arm, want, want_bd = jax_streams
    _, tree = moe_params
    dropped = []
    real_route = tmoe.route

    def counting_route(logits, k, cap):
        r = real_route(logits, k, cap)
        dropped.append(int((~r.kept).sum()))
        return r
    monkeypatch.setattr(tmoe, "route", counting_route)
    eng = tllm.LLMEngine(TC, params_from_numpy(tree, "cpu"), num_slots=4,
                         max_len=64, compute_dtype=torch.float32,
                         device="cpu", **ARMS[arm])
    try:
        got = [_run(eng, tllm, w) for w in _waves(arm)]
        bd = eng.breakdown()
    finally:
        eng.shutdown()
    assert not eng._thread.is_alive()
    assert [len(t) for w in got for t in w] == [MAX_TOKENS] * sum(
        map(len, _waves(arm)))
    assert got == want
    assert bd == want_bd
    assert sum(dropped) > 0
    if arm == "paged_prefix":
        assert bd["prefix_cache"]["hits"] == 2


def test_last_writer_makes_duplicate_writes_end_as_jax_s():
    """Cache and state writes gather their values through ``last_writer``,
    so a scatter with duplicate destinations ends as XLA's on the CPU (the
    last write wins), at a size where torch's own index_put does not keep
    that order."""
    from ray_tpu_torch.models.decode import last_writer
    keys = torch.tensor([3, 1, 3, 0, 1, 3, 2])
    assert last_writer(keys).tolist() == [5, 4, 5, 3, 4, 5, 6]
    rng = np.random.default_rng(0)
    pages, offs = rng.integers(0, 3, 2048), np.arange(2048) % 8
    vals = rng.standard_normal((2048, 32)).astype(np.float32)
    want = np.asarray(jnp.zeros((3, 8, 32)).at[pages, offs].set(vals))
    got = torch.zeros((3, 8, 32))
    p, o = torch.from_numpy(pages), torch.from_numpy(offs)
    got[p, o] = torch.from_numpy(vals)[last_writer(p * 8 + o)]
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_paged_prefill_equals_dense_on_a_full_bucket_only(moe_params):
    """On a padded batch the dense and the paged prefill differ by the
    reference's own semantics: the dense prefill's padding positions attend
    over the padded row, the paged prefill's send their K/V to the null
    page, and with MoE those positions compete with the real tokens for
    expert capacity.  JAX's two modes differ so, and the port matches JAX
    in each mode; on a full bucket the two modes agree (chip_smoke.py holds
    the paged prefill to the dense one on such a batch)."""
    from ray_tpu.models import decode as jdec
    from ray_tpu.models import paged_decode as jpd
    from ray_tpu_torch.models import decode as tdec
    from ray_tpu_torch.models import paged_decode as tpd

    params, tree = moe_params
    tparams = params_from_numpy(tree, "cpu")
    page, pages, width = 8, 8, 64
    bt = 1 + np.arange(2 * pages, dtype=np.int32).reshape(2, pages)

    def both(toks, lens):
        j_args = (jnp.asarray(toks), jnp.asarray(lens),
                  jnp.arange(2, dtype=jnp.int32))
        t_args = (torch.from_numpy(toks), torch.from_numpy(lens),
                  torch.arange(2, dtype=torch.int32))
        jc = jpd.init_paged_cache(JC, 2 * pages + 1, page, 2, pages,
                                  jnp.float32)
        jc["block_table"] = jnp.asarray(bt)
        tc = tpd.init_paged_cache(TC, 2 * pages + 1, page, 2, pages,
                                  torch.float32, "cpu")
        tc["block_table"][:] = torch.from_numpy(bt)
        out = {
            "jax_dense": jdec.prefill(params, jdec.init_kv_cache(
                JC, 2, width, jnp.float32), *j_args, JC, jnp.float32)[1],
            "jax_paged": jpd.paged_prefill(params, jc, *j_args,
                                           jnp.zeros(2, jnp.int32), JC,
                                           jnp.float32)[1],
            "dense": tdec.prefill(tparams, tdec.init_kv_cache(
                TC, 2, width, torch.float32, "cpu"), *t_args, TC,
                torch.float32)[1],
            "paged": tpd.paged_prefill(tparams, tc, *t_args,
                                       torch.zeros(2, dtype=torch.int32), TC,
                                       torch.float32)[1]}
        return {k: np.asarray(v) for k, v in out.items()}

    rng = np.random.default_rng(4)
    toks = rng.integers(1, JC.vocab_size, (2, width)).astype(np.int32)
    padded = toks.copy()
    padded[0, 20:], padded[1, 40:] = 0, 0
    got = both(padded, np.asarray([20, 40], np.int32))
    for mode in ("dense", "paged"):
        np.testing.assert_allclose(got[mode], got[f"jax_{mode}"], atol=1e-4)
    assert np.abs(got["jax_dense"] - got["jax_paged"]).max() > 1e-2
    got = both(toks, np.asarray([width, width], np.int32))
    np.testing.assert_allclose(got["paged"], got["dense"], atol=1e-4)
    np.testing.assert_allclose(got["dense"], got["jax_dense"], atol=1e-4)
