"""The port's paged KV cache against the JAX package's, on the same params.

Params come from the JAX package's ``init_params`` (f32), carried over with
``params_from_numpy``; block tables, prompts and windows are numpy arrays
fed to both.  Three tiny configs: Llama-style (RoPE, GQA), GPT-2 flags
(learned positions, LayerNorm, tied embeddings), a logit softcap small
enough to bend the scores, and MoE (4 experts, top 2).  Logits and the K/V gathered through the block
tables agree within 1e-4; greedy tokens are identical.  The host-side
``PageAllocator`` and ``PrefixCache`` must give the JAX classes' results on
one sequence of operations, and the prefix hash must be the router's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import decode as jdec
from ray_tpu.models import paged_decode as jpd
from ray_tpu.models import transformer as jtr
from ray_tpu.serve.router import _block_hash
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import decode as tdec
from ray_tpu_torch.models import paged_decode as tpd
from ray_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4
PAGE, MAX_PAGES, NUM_PAGES, SLOTS = 8, 6, 32, 3
F32 = jnp.float32

# jitted once: the eager JAX calls would retrace their layer scan per call
_jprefill = jax.jit(jpd.paged_prefill, static_argnums=(6, 7))
_jstep = jax.jit(jpd.paged_decode_step, static_argnums=(4, 5))
_jverify = jax.jit(jpd.paged_verify_window, static_argnums=(4, 5))

_BASE = jcfg.TransformerConfig(vocab_size=128, num_layers=2, hidden_size=64,
                               num_heads=4, num_kv_heads=2, mlp_size=128,
                               max_seq_len=64)
CONFIGS = {
    "llama": _BASE,
    "gpt2": dataclasses.replace(_BASE, use_rope=False, use_rmsnorm=False,
                                use_swiglu=False, tied_embeddings=True),
    "softcap": dataclasses.replace(_BASE, attn_logit_softcap=0.5),
    "moe": dataclasses.replace(_BASE, num_experts=4),
}


def _model(name):
    cfg = CONFIGS[name]
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, dtype=F32)
    tree = jax.tree.map(np.asarray, params)
    return (cfg, tcfg.TransformerConfig(**dataclasses.asdict(cfg)),
            jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def llama():
    return _model("llama")


def _tables():
    """Slot s owns pages 1 + s*MAX_PAGES .. ; the scratch slot (last) keeps
    the null page everywhere."""
    bt = np.zeros((SLOTS, MAX_PAGES), np.int32)
    for s in range(SLOTS - 1):
        bt[s] = np.arange(1 + s * MAX_PAGES, 1 + (s + 1) * MAX_PAGES)
    return bt


def _caches(cfg, tc, bt):
    jc = jpd.init_paged_cache(cfg, NUM_PAGES, PAGE, SLOTS, MAX_PAGES, F32)
    jc = dict(jc, block_table=jnp.asarray(bt))
    tcache = tpd.init_paged_cache(tc, NUM_PAGES, PAGE, SLOTS, MAX_PAGES,
                                  torch.float32, "cpu")
    tcache["block_table"].copy_(torch.from_numpy(bt))
    return jc, tcache


def _t(a):
    return torch.from_numpy(np.array(a))


def _gather(cache, slot, n_pos):
    """Per-position K/V through the slot's block table: [L, n, NKV, D]."""
    bt = np.asarray(cache["block_table"])[slot]
    pos = np.arange(n_pos)
    k = np.asarray(cache["k"])[:, bt[pos // PAGE], pos % PAGE]
    v = np.asarray(cache["v"])[:, bt[pos // PAGE], pos % PAGE]
    return k, v


def _assert_same_cache(jc, tcache, slots):
    jlen = np.asarray(jc["length"])
    np.testing.assert_array_equal(tcache["length"].numpy(), jlen)
    for s in slots:
        for a, b in zip(_gather(jc, s, jlen[s]), _gather(tcache, s, jlen[s])):
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def _prompts(vocab, lens, width, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks


def test_prefill_decode_and_verify_match_jax(model):
    """One prefill (two prompts, one padded row into the scratch slot),
    two decode steps (the second with slot 1 inactive: its write goes to
    the null page) and a 3-token verify window that crosses a page
    boundary."""
    cfg, tc, jp, tp = model
    jc, tcache = _caches(cfg, tc, _tables())
    toks = _prompts(cfg.vocab_size, (11, 5, 1), 16)
    lengths = np.array([11, 5, 1], np.int32)
    slots = np.array([0, 1, 2], np.int32)
    start = np.zeros(3, np.int32)
    jc, jl = _jprefill(jp, jc, *map(jnp.asarray, (toks, lengths, slots,
                                                  start)), cfg, F32)
    tcache, tl = tpd.paged_prefill(tp, tcache, *map(_t, (toks, lengths, slots,
                                                         start)), tc,
                                   torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_same_cache(jc, tcache, (0, 1))

    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
    for active in ([True, True, False], [True, False, False]):
        act = np.array(active)
        jc, jl = _jstep(jp, jc, jnp.asarray(nxt), jnp.asarray(act), cfg, F32)
        tcache, tl = tpd.paged_decode_step(tp, tcache, _t(nxt), _t(act), tc,
                                           torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _assert_same_cache(jc, tcache, (0, 1))
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)

    window = np.stack([nxt, nxt + 1, nxt + 2], 1).astype(np.int32)
    act = np.array([True, True, False])
    jc, jl = _jverify(jp, jc, jnp.asarray(window), jnp.asarray(act), cfg, F32)
    tcache, tl = tpd.paged_verify_window(tp, tcache, _t(window), _t(act), tc,
                                         torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_same_cache(jc, tcache, (0, 1))
    assert tcache["length"].tolist() == [11 + 2 + 3, 5 + 1 + 3, 1]


def test_prefix_reuse_prefill_matches_cold_prefill(llama):
    """Slot 1 reuses slot 0's first two pages (16 tokens) and prefills only
    the suffix from start_pos 16: the same last-token logits and K/V as the
    cold prefill of the whole prompt, and JAX's reuse prefill's."""
    cfg, tc, jp, tp = llama
    bt = _tables()
    bt[1, :2] = bt[0, :2]
    jc, tcache = _caches(cfg, tc, bt)
    full = _prompts(cfg.vocab_size, (21,), 32, seed=4)
    cold = (full, np.array([21], np.int32), np.array([0], np.int32),
            np.array([0], np.int32))
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = full[0, 16:21]
    warm = (suffix, np.array([5], np.int32), np.array([1], np.int32),
            np.array([16], np.int32))
    tcache, t_cold = tpd.paged_prefill(tp, tcache, *map(_t, cold), tc,
                                       torch.float32)
    tcache, t_warm = tpd.paged_prefill(tp, tcache, *map(_t, warm), tc,
                                       torch.float32)
    np.testing.assert_allclose(t_warm.numpy(), t_cold.numpy(), atol=ATOL,
                               rtol=0)
    for a, b in zip(_gather(tcache, 0, 21), _gather(tcache, 1, 21)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)

    jc, _ = _jprefill(jp, jc, *map(jnp.asarray, cold), cfg, F32)
    jc, j_warm = _jprefill(jp, jc, *map(jnp.asarray, warm), cfg, F32)
    np.testing.assert_allclose(t_warm.numpy(), np.asarray(j_warm), atol=ATOL,
                               rtol=0)
    _assert_same_cache(jc, tcache, (0, 1))


def test_loops_and_admit_match_jax(llama):
    """paged_prefill_admit, then paged_decode_state_loop (with a slot whose
    budget runs out mid-dispatch) and paged_decode_loop: greedy tokens
    identical to JAX's, caches within 1e-4."""
    cfg, tc, jp, tp = llama
    bt = _tables()
    jc, tcache = _caches(cfg, tc, np.zeros_like(bt))
    toks = _prompts(cfg.vocab_size, (9, 14), 16, seed=2)
    admit = (toks, np.array([9, 14], np.int32), np.array([0, 1], np.int32),
             np.zeros(2, np.int32), bt[:2], np.zeros(2, np.float32),
             np.array([3, 12], np.int32), np.full(2, -1, np.int32),
             np.array([True, True]))
    jstate = jdec.init_decode_state(SLOTS, jax.random.PRNGKey(1))
    tstate = tdec.init_decode_state(SLOTS, torch.Generator().manual_seed(1))
    jc, jstate, jfirst = jax.jit(jpd.paged_prefill_admit,
                                 static_argnums=(12, 13, 14))(
        jp, jc, jstate, *map(jnp.asarray, admit), cfg, 0, F32)
    tcache, tstate, tfirst = tpd.paged_prefill_admit(
        tp, tcache, tstate, *map(_t, admit), tc, 0, torch.float32)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(tcache["block_table"].numpy(),
                                  np.asarray(jc["block_table"]))

    jc, jstate, jem = jax.jit(jpd.paged_decode_state_loop,
                              static_argnums=(3, 4, 5, 6))(
        jp, jc, jstate, 5, cfg, 0, F32)
    tcache, tstate, tem = tpd.paged_decode_state_loop(
        tp, tcache, tstate, 5, tc, 0, torch.float32)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for key in ("tokens", "active", "budget"):
        np.testing.assert_array_equal(tstate[key].numpy(),
                                      np.asarray(jstate[key]))
    assert tstate["active"].tolist() == [False, True, False]
    _assert_same_cache(jc, tcache, (0, 1))

    act = np.array([False, True, False])
    last = np.asarray(jstate["tokens"])
    jc, jlast, jem = jax.jit(jpd.paged_decode_loop,
                             static_argnums=(6, 7, 8, 9))(
        jp, jc, jnp.asarray(last), jnp.asarray(act), jnp.zeros(SLOTS, F32),
        jax.random.PRNGKey(2), 4, cfg, 0, F32)
    tcache, tlast, tem = tpd.paged_decode_loop(
        tp, tcache, _t(last), _t(act), torch.zeros(SLOTS),
        torch.Generator().manual_seed(2), 4, tc, 0, torch.float32)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    _assert_same_cache(jc, tcache, (0, 1))


def test_allocator_and_prefix_cache_match_jax():
    """One sequence of alloc / incref / release / insert / match / evict
    on both packages' classes: the same results, stats and digests."""
    page = 4
    prompt_a = list(range(1, 15))          # 3 full pages + 2
    prompt_b = prompt_a[:8] + [99] * 6     # shares the first 2 pages
    seen = []
    for mod in (jpd, tpd):
        alloc = mod.PageAllocator(12)
        cache = mod.PrefixCache(alloc, page)
        log = [alloc.alloc(4), alloc.available(), alloc.used()]
        pages_a = log[0]
        cache.insert(prompt_a, pages_a[:3])
        alloc.release(pages_a)
        log += [alloc.available(), cache.stats()]
        reused, pages = cache.match_prefix(prompt_b, max_pages=3)
        cache.count_lookup(reused)
        log += [reused, pages, cache.match_prefix(prompt_a, max_pages=1)]
        alloc.incref(pages)
        log += [alloc.alloc(20), alloc.alloc(alloc.available())]
        alloc.release(pages + pages)
        log += [cache.evict_some(2), alloc.available(), cache.stats(),
                cache.first_page_digest(), cache.first_page_digest(0)]
        cache.insert(prompt_b, [7, 8, 9])
        log += [cache.first_page_digest(), cache.stats(), alloc.used()]
        seen.append(log)
    assert seen[1] == seen[0]


def test_prefix_hash_is_the_routers():
    tokens = [11, 22, 33, 44, 55, 66, 77, 88, 99, 101, 70000, 2 ** 31 - 1]
    for page in (4, 8, 12):
        got = tpd.PrefixCache._hash(tokens[:page])
        assert got == jpd.PrefixCache._hash(tokens[:page])
        assert got.hex()[:8] == _block_hash(tokens, page)
