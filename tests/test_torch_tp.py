"""Tensor parallelism in the port's LLMEngine against the JAX engine's.

The JAX engine shards its params and KV cache over a two-device ``tp`` mesh
of the virtual CPU devices (tests/conftest.py); the port splits the same
numpy params into two shards on the CPU (``device="cpu"``: one device
holding both shards, the port's counterpart of the virtual mesh).  Three
float32 tiny configs: the dense ``tiny()``, a biased one (LayerNorm, GELU
MLP, learned positions: ``bq``/``bk``/``bv``, ``bo``, ``b_in`` and
``b_out``, drawn at random so that a bias added once per shard shows) and
``tiny(experts=4)``.  Shard leaves must equal JAX's addressable shards
exactly; greedy streams, ``breakdown()`` and ``prefix_digest()`` must
equal the JAX engine's at tp=2 and the port's at tp=1; logits and caches
agree within 1e-4 (the two shards' partial sums add in another order).
"""

import dataclasses
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import decode as jdec
from ray_tpu.models import transformer as jtr
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import decode as tdec
from ray_tpu_torch.models.convert import (params_from_numpy, tp_axis,
                                          tp_params_from_numpy)
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.serve import llm as tllm

ATOL = 1e-4
TP = 2
MAX_TOKENS = 8
ENGINE = dict(num_slots=4, max_len=64)
PAGED = dict(paged=True, page_size=8)
CONFIGS = {
    "dense": jcfg.tiny(),
    "biased": dataclasses.replace(jcfg.tiny(), use_rmsnorm=False,
                                  use_swiglu=False, use_rope=False),
    "moe": jcfg.tiny(experts=4),
}
# (config, mode): the dense and biased configs in every mode, MoE dense and
# paged (with MoE, prefix reuse changes a call's batch and so what capacity
# drops: the reference's semantics, tests/test_torch_moe_model.py)
RUNS = [(c, m) for c in ("dense", "biased") for m in ("dense", "paged",
                                                      "paged_prefix")] + [
    ("moe", "dense"), ("moe", "paged")]


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _set(tree, path, value):
    *keys, last = path.strip("/").split("/")
    for k in keys:
        tree = tree[k]
    tree[last] = value


@pytest.fixture(scope="module")
def models():
    """Per config: (the JAX config, JAX params, the same as numpy).  Biases
    and norm scales are drawn at random (numpy seed 0): at init they are
    zeros and ones, which hide a bias added on every shard."""
    rng = np.random.default_rng(0)
    out = {}
    for name, cfg in CONFIGS.items():
        tree = jax.tree.map(np.asarray, jtr.init_params(
            jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
        for path, leaf in list(_leaves(tree)):
            key = path.rsplit("/", 1)[1]
            if key in ("bq", "bk", "bv", "bo", "b_in", "b_out", "bias"):
                _set(tree, path, rng.normal(0, 0.5, leaf.shape)
                     .astype(np.float32))
            elif key == "scale":
                _set(tree, path, rng.uniform(0.5, 1.5, leaf.shape)
                     .astype(np.float32))
        out[name] = (cfg, jax.tree.map(jnp.asarray, tree), tree)
    return out


def _tcfg(cfg):
    return tcfg.TransformerConfig(**dataclasses.asdict(cfg))


def _jax_engine(cfg, jparams, tp, **kw):
    return jllm.LLMEngine(cfg, jparams, compute_dtype=jnp.float32, tp=tp,
                          **ENGINE, **kw)


def _torch_engine(cfg, tree, tp, **kw):
    return tllm.LLMEngine(_tcfg(cfg), params_from_numpy(tree, "cpu"),
                          compute_dtype=torch.float32, device="cpu", tp=tp,
                          **ENGINE, **kw)


def _waves(mode, vocab):
    """The prompts of one mode, in waves run one after the other: four
    requests in two buckets; the prefix mode's second wave shares the
    first's 24-token (three-page) prefix and hits the prefix cache."""
    rng = np.random.default_rng(3)
    if mode != "paged_prefix":
        return [[rng.integers(1, vocab, n).tolist() for n in (5, 9, 20, 40)]]
    prefix = rng.integers(1, vocab, 24).tolist()
    return [[prefix + rng.integers(1, vocab, n).tolist() for n in (3, 6)]
            for _ in range(2)]


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


def _serve(eng, mod, waves):
    try:
        outs = [_run(eng, mod, w) for w in waves]
        return outs, eng.breakdown(), eng.prefix_digest()
    finally:
        eng.shutdown()


def _cache_np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def _joined(caches):
    """Shard caches -> one cache: K/V concatenated on the KV-head axis,
    the replicated entries from shard 0."""
    out = {k: v.numpy() for k, v in caches[0].items()}
    for key in ("k", "v"):
        out[key] = np.concatenate([c[key].numpy() for c in caches], axis=3)
    return out


def _assert_close(got, want, atol=ATOL):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# The mesh and the all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(tp=2), 8), (dict(fsdp=2, tp=4), 8),
    (dict(dp=2, fsdp=-1, tp=2), 8), (dict(fsdp=1, tp=2), 2),
    (dict(fsdp=-1, tp=-1), 8), (dict(fsdp=-1, tp=3), 8),
    (dict(fsdp=1, tp=2), 4)])
def test_mesh_spec_sizes_and_errors_match_the_reference(spec, n):
    """``resolve`` gives the reference's sizes, or raises its error;
    ``build`` lays the devices out in the reference's shape and axis
    order."""
    try:
        want = jmesh.MeshSpec(**spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh.MeshSpec(**spec).resolve(n)
        return
    assert tmesh.MeshSpec(**spec).resolve(n) == want
    devs = [torch.device("cpu")] * n
    mesh = tmesh.MeshSpec(**spec).build(devs)
    jm = jmesh.MeshSpec(**spec).build(jax.devices()[:n])
    assert mesh.axis_names == jm.axis_names == tmesh.AXIS_ORDER
    assert mesh.devices.shape == jm.devices.shape
    assert mesh.shape == dict(jm.shape)
    assert all(tmesh.mesh_axis_size(mesh, a) == jmesh.mesh_axis_size(jm, a)
               for a in tmesh.AXIS_ORDER)


def test_all_reduce_sums_in_shard_order_into_tensors_of_their_own():
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
             torch.tensor([1.0, 1e-8])]
    out = tmesh.all_reduce(parts)
    want = (parts[0] + parts[1]) + parts[2]
    assert len(out) == 3 and all(torch.equal(o, want) for o in out)
    assert len({o.data_ptr() for o in out}) == 3
    out[1].add_(1.0)                    # a shard's in-place op stays its own
    assert torch.equal(out[0], want) and torch.equal(out[2], want)
    one = torch.ones(3)
    assert tmesh.all_reduce([one])[0] is one


# ---------------------------------------------------------------------------
# Splitting the params and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("paged", [False, True])
def test_shard_leaves_equal_jax_addressable_shards(models, config, paged):
    """Every param and cache leaf of port shard i equals the data of the
    JAX engine's ``addressable_shards[i]``, bit for bit."""
    cfg, jparams, tree = models[config]
    kw = PAGED if paged else {}
    jeng = _jax_engine(cfg, jparams, TP, **kw)
    teng = _torch_engine(cfg, tree, TP, **kw)
    try:
        for jtree, shards in ((jeng.params, teng.params),
                              (jeng.cache, teng.cache)):
            assert isinstance(shards, list) and len(shards) == TP
            flat = dict(_leaves(jtree))
            for i, shard in enumerate(shards):
                got = dict(_leaves(shard))
                assert got.keys() == flat.keys()
                for path, leaf in flat.items():
                    data = np.asarray(leaf.addressable_shards[i].data)
                    t = got[path]
                    assert t.is_contiguous() and t.device == teng.devices[i]
                    np.testing.assert_array_equal(t.numpy(), data,
                                                  err_msg=path)
    finally:
        jeng.shutdown()
        teng.shutdown()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_tp_params_from_numpy_equal_the_engines_split(models, config):
    """The converter's shards (numpy cut on the host, each part straight to
    its device) equal ``_apply_tp_sharding`` of the whole tree, and an
    engine takes them as they are."""
    cfg, _, tree = models[config]
    shards = tp_params_from_numpy(tree, ["cpu"] * TP)
    eng = _torch_engine(cfg, tree, TP)
    try:
        for got, want in zip(shards, eng.params):
            g, w = dict(_leaves(got)), dict(_leaves(want))
            assert g.keys() == w.keys()
            assert all(torch.equal(g[p], w[p]) for p in w)
        # split leaves are cut, replicated ones whole
        for path, leaf in _leaves(tree):
            axis = tp_axis(path, leaf.ndim)
            shape = list(leaf.shape)
            if axis is not None:
                shape[axis] //= TP
            assert list(dict(_leaves(shards[1]))[path].shape) == shape
    finally:
        eng.shutdown()
    again = tllm.LLMEngine(_tcfg(cfg), shards, compute_dtype=torch.float32,
                           device="cpu", tp=TP, **ENGINE)
    one = _torch_engine(cfg, tree, 1)
    try:
        assert again.params is shards
        assert again.generate([1, 2, 3], max_tokens=4) == one.generate(
            [1, 2, 3], max_tokens=4)
    finally:
        again.shutdown()
        one.shutdown()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config,mode", RUNS)
def test_tp2_streams_equal_jax_tp2_and_port_tp1(models, config, mode):
    """Greedy streams, ``breakdown()`` and ``prefix_digest()`` of the port
    at tp=2 equal the JAX engine's at tp=2 and the port's at tp=1; at the
    end the shard caches, joined on the KV-head axis, equal the JAX
    engine's cache within 1e-4."""
    cfg, jparams, tree = models[config]
    kw = {} if mode == "dense" else PAGED
    waves = _waves(mode, cfg.vocab_size)
    jeng = _jax_engine(cfg, jparams, TP, **kw)
    want = _serve(jeng, jllm, waves)
    teng = _torch_engine(cfg, tree, TP, **kw)
    got = _serve(teng, tllm, waves)
    one = _serve(_torch_engine(cfg, tree, 1, **kw), tllm, waves)
    assert got == want
    assert got == one
    outs, bd, digest = got
    assert [len(t) for w in outs for t in w] == [MAX_TOKENS] * sum(
        map(len, waves))
    if mode == "paged_prefix":
        assert bd["prefix_cache"]["hits"] == 2
        assert bd["prefix_cache"]["tokens_reused"] == 2 * 24
        assert digest["blocks"]
    _assert_close(_joined(teng.cache), _cache_np(jeng.cache))
    for shard in teng.cache[1:]:          # the replicated entries stay so
        for key in set(shard) - {"k", "v"}:
            assert torch.equal(shard[key], teng.cache[0][key]), key


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_tp2_prefill_logits_and_caches_match_jax(models, config):
    """One dense prefill (a batch of three prompts, one padding row into
    the scratch slot) on the split params: logits within 1e-4 of the JAX
    prefill on its tp=2 shards and of the port's at tp=1; each shard's
    cache equals JAX's at that shard's KV heads within 1e-4."""
    cfg, jparams, tree = models[config]
    rng = np.random.default_rng(7)
    lengths = np.asarray([5, 16, 11, 1], np.int32)
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lengths[:3]):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    slots = np.asarray([0, 2, 1, 4], np.int32)
    jeng = _jax_engine(cfg, jparams, TP)
    teng = _torch_engine(cfg, tree, TP)
    tone = _torch_engine(cfg, tree, 1)
    try:
        jcache, jlogits = jax.jit(
            lambda p, c, t, n, s: jdec.prefill(p, c, t, n, s, cfg,
                                               jnp.float32))(
            jeng.params, jeng.cache, toks, lengths, slots)
        args = [torch.from_numpy(a) for a in (toks, lengths, slots)]
        with torch.inference_mode():
            tcache, tlogits = tdec.prefill(teng.params, teng.cache, *args,
                                           _tcfg(cfg), torch.float32)
            _, one = tdec.prefill(tone.params, tone.cache, *args, _tcfg(cfg),
                                  torch.float32)
    finally:
        for e in (jeng, teng, tone):
            e.shutdown()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlogits.numpy(), one.numpy(), atol=ATOL,
                               rtol=0)
    kv = cfg.num_kv_heads // TP
    for key in ("k", "v"):
        for i, c in enumerate(tcache):
            np.testing.assert_allclose(
                c[key].numpy(),
                np.asarray(jcache[key])[:, :, :, i * kv:(i + 1) * kv],
                atol=ATOL, rtol=0)
            np.testing.assert_allclose(
                c[key].numpy(), tone.cache[key][:, :, :, i * kv:(i + 1) * kv]
                .numpy(), atol=ATOL, rtol=0)
    assert all(torch.equal(c["length"], tone.cache["length"])
               for c in tcache)


def test_biases_are_added_once_after_the_sum(models):
    """The biased config's replicated output biases ``bo`` and ``b_out``
    are added once, after the all-reduce: tp=2 logits equal tp=1's within
    1e-4, and adding them on every shard would move them by far more."""
    cfg, _, tree = models["biased"]
    tc = _tcfg(cfg)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, cfg.vocab_size, (2, 12)).astype(np.int32))
    lengths = torch.tensor([12, 7], dtype=torch.int32)
    slots = torch.tensor([0, 1], dtype=torch.int32)
    full = params_from_numpy(tree, "cpu")
    # a bias added on both shards: the full model with it twice
    doubled = params_from_numpy(tree, "cpu")
    for mod, key in (("attn", "bo"), ("mlp", "b_out")):
        doubled["blocks"][mod][key] *= 2

    def logits(params, n_shards):
        caches = [tdec.init_kv_cache(dataclasses.replace(
            tc, num_kv_heads=tc.num_kv_heads // n_shards), 3, 16,
            torch.float32, "cpu") for _ in range(n_shards)]
        return tdec.prefill(params, caches if n_shards > 1 else caches[0],
                            toks, lengths, slots, tc, torch.float32)[1]

    with torch.inference_mode():
        want = logits(full, 1)
        got = logits(tp_params_from_numpy(tree, ["cpu"] * TP), TP)
        twice = logits(doubled, 1)
    assert (got - want).abs().max().item() <= ATOL
    assert (twice - want).abs().max().item() > 100 * ATOL


def test_moe_shards_take_one_routing(models, monkeypatch):
    """Under tp the router runs once, on shard 0, and every shard's experts
    take its (expert, slot, kept): in every layer of a prefill and of decode
    steps the shards' routings are equal, and equal to what each shard's
    own replica of the norm'd input routes to.  Pairs are dropped."""
    cfg, _, tree = models["moe"]
    calls = []
    real = tmoe.moe_experts

    def experts(x, r, cap, w_gate, w_in, w_out):
        calls.append((x, r, cap))
        return real(x, r, cap, w_gate, w_in, w_out)

    monkeypatch.setattr(tmoe, "moe_experts", experts)
    eng = _torch_engine(cfg, tree, TP)
    try:
        outs = _run(eng, tllm, _waves("dense", cfg.vocab_size)[0])
        router = [p["blocks"]["moe"]["router"] for p in eng.params]
    finally:
        eng.shutdown()
    assert all(len(o) == MAX_TOKENS for o in outs)
    assert len(calls) % (TP * cfg.num_layers) == 0
    dropped = 0
    for n in range(0, len(calls), TP):
        layer = (n // TP) % cfg.num_layers
        shard_calls = calls[n:n + TP]
        first = shard_calls[0][1]
        for s, (x, r, cap) in enumerate(shard_calls):
            for f in ("expert", "slot", "kept"):
                assert torch.equal(getattr(r, f), getattr(first, f))
            own = tmoe.moe_route(x, router[s][layer], cfg.experts_per_token,
                                 cfg.expert_capacity_factor)[1]
            assert torch.equal(own.expert, first.expert)
            assert torch.equal(own.kept, first.kept)
        dropped += int((~first.kept).sum())
    assert dropped > 0


# ---------------------------------------------------------------------------
# What tp refuses
# ---------------------------------------------------------------------------

def test_tp_that_does_not_divide_the_kv_heads_raises():
    with pytest.raises(ValueError, match="must divide num_kv_heads=2"):
        tllm.LLMEngine(tcfg.tiny(), device="cpu", tp=3)


def test_spec_decoding_with_tp_raises_as_the_reference():
    with pytest.raises(ValueError, match="does not compose with tp>1"):
        tllm.LLMEngine(tcfg.tiny(), device="cpu", tp=2,
                       spec_decode_enabled=True)
    with pytest.raises(ValueError, match="does not compose with tp>1"):
        jllm.LLMEngine(jcfg.tiny(), tp=2, spec_decode_enabled=True)


@pytest.mark.parametrize("cards", [0, 1])
def test_default_devices_need_a_card_per_shard(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match=f"tp=2 but only {cards} devices"):
        tllm.LLMEngine(tcfg.tiny(), tp=2)


def test_device_list_must_name_every_shard():
    with pytest.raises(ValueError, match="tp=2 needs 2 devices, got 3"):
        tllm.LLMEngine(tcfg.tiny(), tp=2, device=["cpu"] * 3)
    with pytest.raises(ValueError, match="2 param shards|params are on"):
        tllm.LLMEngine(tcfg.tiny(), [{"embed": {"tokens": torch.zeros(1)}}],
                       tp=2, device="cpu")
