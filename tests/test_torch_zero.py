"""The port's dp-manual train step (ZeRO-sharded update, int8 block-quantized
gradient collectives) against the JAX package's, on the same inputs.

JAX runs ``parallel/zero.py`` and ``parallel/quant_collectives.py`` on 4 of
the virtual CPU devices of tests/conftest.py; the port builds the same
dp=4 mesh over four ``"cpu"`` devices and starts from JAX's state, carried
over with ``models/convert.py``.  Everything in float32, on ``tiny()``
configs.

Tolerances: quantization equal to JAX's (a flip of one int8 step allowed
only where x/scale lies within 1e-6 of a half-integer, which none of these
inputs reach), dequantization within 1e-7, the collectives within 1e-6 of
JAX's; the steps' losses, grad norms and params within 1e-4 of JAX's and
tokens exact, params of the quantized step within 1e-3 relative L2 per
leaf (two programs' f32 gradients differ in their last bits, which flips
the int8 rounding of an element that lies near a half step; the count is
printed).  The reference's own gates (``tests/test_chipspeed.py``) hold on
the port with their tolerances, against the port's default dp=4 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.parallel import quant_collectives as jqc
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel import zero as jzero
from ray_tpu.util import jax_compat
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.models.convert import (sharded_state_from_numpy,
                                          zero_state_from_numpy)
from ray_tpu_torch.parallel import OptimizerSpec, init_sharded_state
from ray_tpu_torch.parallel import init_zero_state, make_train_step
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import quant_collectives as tqc
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.parallel import zero as tzero
from ray_tpu_torch.train import load_pytree, save_pytree

DP, BLOCK = 4, 256
JAX_TOL, QUANT_REL_L2 = 1e-4, 1e-3
HALF_INT_TOL = 1e-6
OPT = dict(total_steps=50, warmup_steps=2)
STEPS, BATCH = 3, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: its flat vectors (10^5 elements)
    are above torch's grain, and under the suite's parallel workers its
    threads' barriers oversubscribe the cores (a step took a hundred times
    its time alone).  No tolerance here depends on the thread count."""
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


def _tmesh(dp=DP, **spec):
    return tmesh.MeshSpec(dp=dp, fsdp=1, **spec).build(
        ["cpu"] * dp * int(np.prod(list(spec.values()) or [1])))


def _cfgs(seq=32):
    jc = jcfg.tiny(seq=seq)
    return jc, tcfg.TransformerConfig(**dataclasses.asdict(jc))


def _batches(vocab, seq, n=STEPS, seed=7):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (BATCH, seq + 1))
             .astype(np.int32)} for _ in range(n)]


def _flips(q_a, q_b, y):
    """Elements whose int8 values differ: each by one step, at x/scale
    within HALF_INT_TOL of a half-integer.  -> their count."""
    d = np.abs(q_a.astype(np.int32) - q_b.astype(np.int32))
    at = np.nonzero(d)
    assert d.max(initial=0) <= 1
    off = np.abs(np.abs(y[at]) - np.floor(np.abs(y[at])) - 0.5)
    assert np.all(off <= HALF_INT_TOL), off.max()
    return int(at[0].size)


# ---------------------------------------------------------------------------
# Quantization and the collectives
# ---------------------------------------------------------------------------

def test_quantize_matches_jax_and_holds_its_bound():
    x = (np.random.default_rng(3).standard_normal((4, 4096)) * 10).astype(
        np.float32)
    jq, js = (np.asarray(a) for a in jqc.quantize_int8_block(
        jnp.asarray(x), block=BLOCK))
    tq, ts = tqc.quantize_int8_block(torch.from_numpy(x), block=BLOCK)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), js)
    y = (x.reshape(4, 16, BLOCK) / js[..., None]).reshape(4, 4096)
    print("int8 flips against JAX:", _flips(tq.numpy(), jq, y))
    back = tqc.dequantize_int8_block(tq, ts, BLOCK).numpy()
    jback = np.asarray(jqc.dequantize_int8_block(jnp.asarray(tq.numpy()),
                                                 jnp.asarray(ts.numpy()),
                                                 BLOCK))
    np.testing.assert_allclose(back, jback, rtol=0, atol=1e-7)
    # the per-block bound: |err| <= scale / 2 = amax / 254
    amax = np.abs(x.reshape(4, 16, BLOCK)).max(-1, keepdims=True)
    bound = np.broadcast_to(amax / 254.0 + 1e-7, (4, 16, BLOCK))
    assert np.all(np.abs(back - x) <= bound.reshape(4, 4096))
    # deterministic, and all-zero blocks come back exact
    tq2, ts2 = tqc.quantize_int8_block(torch.from_numpy(x), block=BLOCK)
    assert torch.equal(tq, tq2) and torch.equal(ts, ts2)
    z = torch.zeros(2 * BLOCK)
    qz, sz = tqc.quantize_int8_block(z, block=BLOCK)
    assert torch.equal(sz, torch.ones(2))
    assert torch.equal(tqc.dequantize_int8_block(qz, sz, BLOCK), z)
    with pytest.raises(ValueError, match="does not divide"):
        tqc.quantize_int8_block(torch.zeros(BLOCK + 1), block=BLOCK)
    assert tqc.quant_error_bound(2.54, BLOCK, 4) == jqc.quant_error_bound(
        2.54, BLOCK, 4)


def test_stochastic_rounding_unbiased_and_repeatable():
    x = torch.full((BLOCK,), 0.3)   # worst case: a mid-step value
    _, scale = tqc.quantize_int8_block(x, block=BLOCK)
    step = float(scale[0])
    acc = torch.zeros_like(x)
    n = 64
    for i in range(n):
        gen = torch.Generator().manual_seed(i)
        q, s = tqc.quantize_int8_block(x, block=BLOCK, stochastic=True,
                                       generator=gen)
        acc += tqc.dequantize_int8_block(q, s, BLOCK)
    bias = float((acc / n - x).abs().max())
    assert bias < step / 4, (bias, step)
    a, b = (tqc.quantize_int8_block(x, BLOCK, True,
                                    torch.Generator().manual_seed(5))[0]
            for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        tqc.quantize_int8_block(x, BLOCK, stochastic=True)
    with pytest.raises(ValueError, match="one torch.Generator per part"):
        tqc.quantized_all_gather([x, x], block=BLOCK, stochastic=True)


def _jax_collectives(x):
    """The reference test's shard_map body on JAX's 4 CPU devices: the
    exact and the quantized reduce-scatter of every device's row, and the
    quantized all-gather of each device's row."""
    from jax.sharding import PartitionSpec as P
    mesh = jmake_mesh(DP, dp=DP, fsdp=1)

    def body(xs):
        flat = xs.reshape(-1)
        exact = jax.lax.psum_scatter(flat, "dp", scatter_dimension=0,
                                     tiled=True)
        quant = jqc.quantized_psum_scatter(flat, "dp", DP, block=BLOCK)
        gathered = jqc.quantized_all_gather(flat, "dp", block=BLOCK)
        return exact[None], quant[None], gathered[None]

    fn = jax_compat.shard_map(body, mesh=mesh, in_specs=P(("dp",), None),
                              out_specs=(P(("dp",), None),) * 3,
                              check_vma=False)
    return [np.asarray(a) for a in fn(jnp.asarray(x))]


def test_quantized_collectives_match_jax_and_are_bounded():
    n = 4096
    x = np.random.default_rng(7).standard_normal((DP, n)).astype(np.float32)
    exact_j, quant_j, gathered_j = _jax_collectives(x)
    parts = [torch.from_numpy(r.copy()) for r in x]
    quant = tqc.quantized_psum_scatter(parts, block=BLOCK)
    assert [tuple(q.shape) for q in quant] == [(n // DP,)] * DP
    np.testing.assert_allclose(torch.stack(quant).numpy(),
                               quant_j.reshape(DP, n // DP), rtol=0,
                               atol=1e-6)
    # the same chunk placement as the port's exact reduce_scatter (and
    # JAX's psum_scatter), within the declared bound of it
    exact = tmesh.reduce_scatter(parts, 0)
    np.testing.assert_allclose(torch.stack(exact).numpy(),
                               exact_j.reshape(DP, n // DP), rtol=0,
                               atol=1e-6)
    bound = tqc.quant_error_bound(float(np.abs(x).max()), BLOCK, DP) + 1e-6
    for q, e in zip(quant, exact):
        assert float((q - e).abs().max()) <= bound
    again = tqc.quantized_psum_scatter(parts, block=BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(quant, again))
    gathered = tqc.quantized_all_gather(parts, block=BLOCK)
    assert len(gathered) == DP
    for g, gj in zip(gathered, gathered_j.reshape(DP, DP * n)):
        np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=1e-6)
        assert torch.equal(g, gathered[0])
    with pytest.raises(ValueError, match="do not tile"):
        tqc.quantized_psum_scatter([torch.zeros(BLOCK)] * DP, block=BLOCK)


# ---------------------------------------------------------------------------
# The dp-manual step against JAX's
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(jc, batches, zero, quant):
    """JAX's dp-manual step from its own init: (the initial state as
    numpy, each step's metrics, the final params)."""
    mesh = jmake_mesh(DP, dp=DP, fsdp=1)
    spec = jzero.OptimizerSpec(**OPT)
    opt = spec.build()
    if zero:
        state, sh = jzero.init_zero_state(jc, mesh, spec)
        adam = state.opt_state[0]
        init = (_np(state.params), np.asarray(adam.mu["p"]),
                np.asarray(adam.nu["p"]), np.asarray(adam.count),
                np.asarray(state.step))
    else:
        state, sh = jts.init_sharded_state(jc, mesh, opt)
        adam = state.opt_state[1][0]
        init = (_np(state.params), _np(adam.mu), _np(adam.nu),
                np.asarray(adam.count), np.asarray(state.step))
    step = jts.make_train_step(jc, mesh, opt, sh, compute_dtype=jnp.float32,
                               remat=False, grad_quant_enabled=quant,
                               zero_sharded_update=zero, opt_spec=spec)
    rows = []
    for b in batches:
        state, m = step(state, b)
        rows.append({k: float(v) for k, v in m.items()})
    return init, rows, _np(state.params)


def _port_state(tc, mesh, init, zero):
    if zero:
        return zero_state_from_numpy(*init, mesh)
    return (sharded_state_from_numpy(*init, tts.state_shardings(tc, mesh)),
            tts.state_shardings(tc, mesh))


def _local_flat_grads(jc, tc, params_np, rows):
    """Replica 0's flat gradient at the start, JAX's (``ravel_pytree``)
    and the port's (``_leaves`` order), padded as the step pads them."""
    batch = {"tokens": jnp.asarray(rows)}
    jg = jax.jit(jax.grad(lambda p: jtr.causal_lm_loss(
        p, batch, cfg=jc, compute_dtype=jnp.float32)[0]))(
        jax.tree.map(jnp.asarray, params_np))
    jflat = np.asarray(ravel_pytree(jg)[0])
    from ray_tpu_torch.models.convert import params_from_numpy
    tp = params_from_numpy(params_np, "cpu")
    leaves = tts._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = ttr.causal_lm_loss(tp, {"tokens": torch.from_numpy(rows)}, tc,
                                  compute_dtype=torch.float32)
    tflat = torch.cat([g.reshape(-1) for g in
                       torch.autograd.grad(total, leaves)]).numpy()
    npad = tzero._padded(tflat.size, DP, BLOCK)
    return (np.pad(jflat, (0, npad - jflat.size)),
            np.pad(tflat, (0, npad - tflat.size)))


@pytest.mark.parametrize("arm", ["zero", "quant"])
def test_dp_step_matches_jax(arm):
    zero, quant = arm == "zero", arm == "quant"
    jc, tc = _cfgs()
    batches = _batches(tc.vocab_size, tc.max_seq_len)
    init, jrows, jparams = _jax_run(jc, batches, zero, quant)
    mesh = _tmesh()
    state, sh = _port_state(tc, mesh, init, zero)
    if zero:
        # the flat layout is ravel_pytree's, bit for bit
        flat = tzero._flat_params(tts._leaves(state.params), 0, list(
            tzero._spans(state.params).values()), init[1].size)
        want = np.asarray(ravel_pytree(init[0])[0])
        np.testing.assert_array_equal(flat[:want.size].detach().numpy(),
                                      want)
    step = make_train_step(tc, mesh, tts.make_optimizer(**OPT), sh,
                           compute_dtype=torch.float32, remat=False,
                           grad_quant_enabled=quant, zero_sharded_update=zero,
                           opt_spec=OptimizerSpec(**OPT))
    for b, jr in zip(batches, jrows):
        state, m = step(state, b)
        assert float(m["tokens"]) == jr["tokens"]
        for k in ("loss", "total_loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(jr[k], rel=JAX_TOL), k
    got = dict(_paths(state.params))
    for path, want in _paths(jparams):
        leaf = got[path].full().numpy()
        if zero:
            np.testing.assert_allclose(leaf, want, rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=path)
        else:
            rel = np.linalg.norm(leaf - want) / np.linalg.norm(want)
            assert rel <= QUANT_REL_L2, (path, rel)
    if quant:
        jflat, tflat = _local_flat_grads(
            jc, tc, init[0], batches[0]["tokens"][:BATCH // DP])
        np.testing.assert_allclose(tflat, jflat, rtol=0, atol=1e-5)
        x = jflat.reshape(DP, -1)
        jq, js = (np.asarray(a) for a in jqc.quantize_int8_block(
            jnp.asarray(x), BLOCK))
        tq, ts = tqc.quantize_int8_block(torch.from_numpy(tflat.reshape(
            DP, -1)), BLOCK)
        flips = int((tq.numpy() != jq).sum())
        print(f"int8 flips, replica 0's step-0 gradient, port against JAX: "
              f"{flips} of {jq.size}")


# ---------------------------------------------------------------------------
# The reference's gates (tests/test_chipspeed.py), held on the port
# ---------------------------------------------------------------------------

def _run_arm(cfg, mesh, spec, steps=10, batch=8, **knobs):
    opt = spec.build()
    if knobs.get("zero_sharded_update"):
        state, sh = init_zero_state(cfg, mesh, spec)
    else:
        state, sh = init_sharded_state(cfg, mesh, opt)
    step = make_train_step(cfg, mesh, opt, sh, compute_dtype=torch.float32,
                           opt_spec=spec, **knobs)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        b = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (batch, cfg.max_seq_len + 1))}
        state, m = step(state, b)
        losses.append(float(m["total_loss"]))
    return state, losses, m, step


def test_zero_sharded_update_allclose_replicated():
    cfg = tcfg.tiny()
    mesh = _tmesh()
    spec = OptimizerSpec(total_steps=50, warmup_steps=5)
    s_ref, l_ref, m_ref, _ = _run_arm(cfg, mesh, spec)
    s_zero, l_zero, m_zero, step = _run_arm(cfg, mesh, spec,
                                            zero_sharded_update=True)
    np.testing.assert_allclose(l_zero, l_ref, rtol=1e-5, atol=1e-5)
    ref = dict(_paths(s_ref.params))
    for path, leaf in _paths(s_zero.params):
        np.testing.assert_allclose(leaf.full().numpy(),
                                   ref[path].full().numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=path)
    assert float(m_zero["tokens"]) == float(m_ref["tokens"])
    assert abs(float(m_zero["grad_norm"]) - float(m_ref["grad_norm"])) < 1e-4
    rep_bytes = 2 * 4 * sum(p.numel() for p in tts._leaves(
        tts._map(lambda s: s.parts[0], s_ref.params)))
    assert step.opt_state_bytes < rep_bytes / 2
    # each replica holds its npad/dp chunk of mu and nu
    npad = tzero._padded(rep_bytes // 8, DP, BLOCK)
    assert [p.numel() for p in s_zero.opt_state["mu"].parts] == [
        npad // DP] * DP


def test_grad_quant_arm_tracks_and_is_deterministic():
    cfg = tcfg.tiny()
    mesh = _tmesh()
    spec = OptimizerSpec(total_steps=50, warmup_steps=5)
    _, l_ref, _, st_ref = _run_arm(cfg, mesh, spec, steps=6)
    s_q1, l_q1, _, st_q = _run_arm(cfg, mesh, spec, steps=6,
                                   grad_quant_enabled=True)
    s_q2, l_q2, _, _ = _run_arm(cfg, mesh, spec, steps=6,
                                grad_quant_enabled=True)
    assert l_q1 == l_q2
    for a, b in zip(tts._leaves(s_q1.params), tts._leaves(s_q2.params)):
        assert all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))
    np.testing.assert_allclose(l_q1, l_ref, rtol=5e-3, atol=5e-3)
    wire_q = sum(v for (op, dt), v in st_q.collective_bytes.items()
                 if dt == "int8")
    wire_f = sum(v for (op, dt), v in st_q.collective_bytes.items()
                 if dt == "float32")
    wire_ref = sum(st_ref.collective_bytes.values())
    assert wire_q > 0 and (wire_q + wire_f) < wire_ref / 3


def test_quant_plus_zero_composes():
    cfg = tcfg.tiny()
    mesh = _tmesh()
    spec = OptimizerSpec(total_steps=50, warmup_steps=5)
    _, l_ref, _, _ = _run_arm(cfg, mesh, spec, steps=5)
    s1, l_both, _, step = _run_arm(cfg, mesh, spec, steps=5,
                                   grad_quant_enabled=True,
                                   zero_sharded_update=True,
                                   quant_stochastic=True)
    assert all(np.isfinite(l_both))
    np.testing.assert_allclose(l_both, l_ref, rtol=1e-2, atol=1e-2)
    assert ("all_gather", "float32") in step.collective_bytes
    assert ("reduce_scatter", "int8") in step.collective_bytes
    # stochastic rounding: the same seed gives the same bits
    s2, l_again, _, _ = _run_arm(cfg, mesh, spec, steps=5,
                                 grad_quant_enabled=True,
                                 zero_sharded_update=True,
                                 quant_stochastic=True)
    assert l_again == l_both
    for a, b in zip(tts._leaves(s1.params), tts._leaves(s2.params)):
        assert torch.equal(a.full(), b.full())


# ---------------------------------------------------------------------------
# make_train_step's keywords (C5), state_shardings and save_pytree (C6), the
# accounting attributes
# ---------------------------------------------------------------------------

def test_bench_keywords_with_both_knobs_off_change_nothing():
    # bench.py's import line works against the port: every name of the
    # reference's parallel package, the pipeline's included
    import ray_tpu.parallel as jpar
    import ray_tpu_torch.parallel as tpar
    assert set(jpar.__all__) <= set(tpar.__all__)
    _, tc = _cfgs()
    spec = OptimizerSpec(**OPT)
    batches = _batches(tc.vocab_size, tc.max_seq_len, n=2)
    for mesh in (None, _tmesh(2)):
        runs = []
        for kw in ({}, dict(opt_spec=spec, quant_block=None,
                            quant_stochastic=False)):
            state, sh = init_sharded_state(tc, mesh, spec.build(), seed=0,
                                           **({} if mesh else
                                              {"device": "cpu"}))
            step = make_train_step(tc, mesh, spec.build(), sh,
                                   compute_dtype=torch.float32,
                                   **({} if mesh else {"device": "cpu"}),
                                   **kw)
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
            runs.append((losses, [p.full() if mesh else p.detach()
                                  for p in tts._leaves(state.params)]))
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    # the dp-manual step refuses sequence parallelism, as the reference's
    with pytest.raises(ValueError, match="sequence parallelism"):
        make_train_step(tc, _tmesh(2, sp=2), spec.build(), None,
                        sp_axis="sp", opt_spec=spec, zero_sharded_update=True)
    # the knobs shard over a mesh's dp axis, and only over it
    with pytest.raises(ValueError, match="pass a mesh"):
        make_train_step(tc, None, spec.build(), None, device="cpu",
                        grad_quant_enabled=True)
    with pytest.raises(ValueError, match="dp axis only"):
        make_train_step(tc, _tmesh(2, tp=2), spec.build(), None,
                        zero_sharded_update=True)
    # each arm takes its own state
    mesh = _tmesh(2)
    state, sh = init_sharded_state(tc, mesh, spec.build())
    step = make_train_step(tc, mesh, spec.build(), None, opt_spec=spec,
                           zero_sharded_update=True)
    with pytest.raises(ValueError, match="init_zero_state"):
        step(state, batches[0])


def test_state_shardings_and_save_pytree_take_the_reference_arguments(
        tmp_path):
    _, tc = _cfgs()
    mesh = _tmesh(2, tp=2)
    opt = tts.make_optimizer()
    state, sh = init_sharded_state(tc, mesh, opt)
    assert tts.state_shardings(tc, mesh, opt, state) == tts.state_shardings(
        tc, mesh)
    with pytest.raises(ValueError, match="use_orbax"):
        save_pytree(str(tmp_path / "x"), state, use_orbax=True)
    assert not (tmp_path / "x").exists()
    for flag in (None, False):
        where = save_pytree(str(tmp_path / str(flag)), state,
                            use_orbax=flag)
        back = load_pytree(where, shardings=sh)
        for a, b in zip(tts._leaves(state.params), tts._leaves(back.params)):
            assert torch.equal(a.full(), b.full())


def test_a_zero_state_checkpoint_resumes_in_the_zero_step(tmp_path):
    """A loaded ZeRO state's leaves are tensors of their own; the step
    packs them into each replica's flat buffer and steps as the state it
    was saved from."""
    _, tc = _cfgs()
    mesh = _tmesh(2)
    spec = OptimizerSpec(**OPT)
    batches = _batches(tc.vocab_size, tc.max_seq_len, n=2)
    state, sh = init_zero_state(tc, mesh, spec)
    step = make_train_step(tc, mesh, spec.build(), sh,
                           compute_dtype=torch.float32, opt_spec=spec,
                           zero_sharded_update=True)
    step(state, batches[0])
    back = load_pytree(save_pytree(str(tmp_path), state), shardings=sh)
    want = float(step(state, batches[1])[1]["loss"])
    assert float(step(back, batches[1])[1]["loss"]) == want
    for a, b in zip(tts._leaves(state.params), tts._leaves(back.params)):
        assert all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))
        assert a.parts[0]._base is not None   # packed into one buffer


@pytest.fixture(scope="module")
def jax_dp_shardings():
    """JAX's dp=4 mesh and the shardings of its two inits (built once)."""
    jc, _ = _cfgs()
    mesh = jmake_mesh(DP, dp=DP, fsdp=1)
    spec = jzero.OptimizerSpec(**OPT)
    return (mesh, jts.init_sharded_state(jc, mesh, spec.build())[1],
            jzero.init_zero_state(jc, mesh, spec)[1])


@pytest.mark.parametrize("quant,zero", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_accounting_equals_the_reference(quant, zero, jax_dp_shardings):
    jc, tc = _cfgs()
    jmesh, jsh_rep, jsh_zero = jax_dp_shardings
    mesh = _tmesh()
    spec, jspec = OptimizerSpec(**OPT), jzero.OptimizerSpec(**OPT)
    jstep = jts.make_train_step(
        jc, jmesh, jspec.build(), jsh_zero if zero else jsh_rep,
        grad_quant_enabled=quant, zero_sharded_update=zero, opt_spec=jspec)
    sh = (init_zero_state(tc, mesh, spec) if zero else
          init_sharded_state(tc, mesh, spec.build()))[1]
    step = make_train_step(tc, mesh, spec.build(), sh,
                           grad_quant_enabled=quant, zero_sharded_update=zero,
                           opt_spec=spec)
    assert step.collective_bytes == jstep.collective_bytes
    assert step.opt_state_bytes == jstep.opt_state_bytes
    assert tuple(step.batch_sharding.spec) == tuple(
        jstep.batch_sharding.spec)
    for kw in (dict(grad_quant=quant, zero_update=zero),
               dict(grad_quant=quant, zero_update=zero, quant_block=128)):
        assert tzero.collective_bytes_per_step(tc, mesh, **kw) == (
            jzero.collective_bytes_per_step(jc, jmesh, **kw))
    assert tzero.zero_opt_state_bytes(tc, mesh) == (
        jzero.zero_opt_state_bytes(jc, jmesh))
    # the default step on one device
    one = make_train_step(tc, None, spec.build(), None, device="cpu")
    assert one.batch_sharding is None and one.collective_bytes == {}
    assert one.opt_state_bytes == 2 * tc.num_params() * 4 + 8
