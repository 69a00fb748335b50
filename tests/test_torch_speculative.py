"""The port's speculative decoding against the JAX package's.

A 2-layer tiny target whose second block's outputs are damped by 0.2 (so
a 1-layer sliced draft agrees often enough that both the accept and the
reject paths run, on streams that do not repeat one token), f32, params carried over with ``params_from_numpy``.  The verify
window's logits and caches agree with JAX's within 1e-4 (a window that
crosses ``max_len`` included); the spec rounds' tokens, counts and emit
counts are identical to JAX's and to vanilla greedy decode, for a dense and
a paged target, through a budget clamp and an EOS inside a window.
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
from ray_tpu.models import speculative as jspec
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import decode as tdec
from ray_tpu_torch.models import paged_decode as tpd
from ray_tpu_torch.models import speculative as tspec
from ray_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4
F32 = jnp.float32
SLOTS, MAX_LEN, PAGE = 3, 64, 8
MAX_PAGES = MAX_LEN // PAGE
K, ROUNDS = 4, 5
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [2, 7, 1, 8, 2, 8])

_jverify = jax.jit(jspec.verify_window, static_argnums=(4, 5))
_jround = jax.jit(jspec.spec_state_round, static_argnums=tuple(range(5, 11)))
_jloop = jax.jit(jspec.spec_decode_state_loop,
                 static_argnums=tuple(range(5, 12)))

CFG = jcfg.TransformerConfig(vocab_size=128, num_layers=2, hidden_size=64,
                             num_heads=4, num_kv_heads=2, mlp_size=128,
                             max_seq_len=128)
DCFG = dataclasses.replace(CFG, num_layers=1)
TC = tcfg.TransformerConfig(**dataclasses.asdict(CFG))
TDC = tcfg.TransformerConfig(**dataclasses.asdict(DCFG))


@pytest.fixture(scope="module")
def params():
    raw = jtr.init_params(jax.random.PRNGKey(3), CFG, dtype=F32)
    jp = jspec.damp_block_outputs(raw, 0.2, from_layer=1)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, "cpu")
    return (jp, jspec.make_draft_params(jp, 1), tp,
            tspec.make_draft_params(tp, 1))


def _t(a):
    return torch.from_numpy(np.array(a))


def _prompt_batch(prompts, width=32):
    toks = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return (toks, np.array([len(p) for p in prompts], np.int32),
            np.arange(len(prompts), dtype=np.int32))


def _dense(params, cfg, pkg, max_len=MAX_LEN, prompts=PROMPTS):
    """A dense cache with the prompts prefilled in slots 0.. -> (cache,
    first greedy tokens)."""
    batch = _prompt_batch(prompts, min(32, max_len))
    if pkg == "jax":
        c = jdec.init_kv_cache(cfg, SLOTS, max_len, F32)
        c, logits = jdec.prefill(params, c, *map(jnp.asarray, batch), cfg,
                                 F32)
        return c, np.asarray(jnp.argmax(logits, -1))
    c = tdec.init_kv_cache(cfg, SLOTS, max_len, torch.float32, "cpu")
    c, logits = tdec.prefill(params, c, *map(_t, batch), cfg, torch.float32)
    return c, logits.argmax(-1).numpy()


def _paged(params, cfg, pkg, prompts=PROMPTS):
    """A paged cache, slot s on pages 1 + s*MAX_PAGES.., prompts prefilled."""
    bt = np.zeros((SLOTS, MAX_PAGES), np.int32)
    for s in range(SLOTS - 1):
        bt[s] = np.arange(1 + s * MAX_PAGES, 1 + (s + 1) * MAX_PAGES)
    batch = _prompt_batch(prompts) + (np.zeros(len(prompts), np.int32),)
    n_pages = 1 + (SLOTS - 1) * MAX_PAGES
    if pkg == "jax":
        c = jpd.init_paged_cache(cfg, n_pages, PAGE, SLOTS, MAX_PAGES, F32)
        c = dict(c, block_table=jnp.asarray(bt))
        c, logits = jpd.paged_prefill(params, c, *map(jnp.asarray, batch),
                                      cfg, F32)
        return c, np.asarray(jnp.argmax(logits, -1))
    c = tpd.init_paged_cache(cfg, n_pages, PAGE, SLOTS, MAX_PAGES,
                             torch.float32, "cpu")
    c["block_table"].copy_(torch.from_numpy(bt))
    c, logits = tpd.paged_prefill(params, c, *map(_t, batch), cfg,
                                  torch.float32)
    return c, logits.argmax(-1).numpy()


def _state(pkg, first, budget, eos, temps=(0.0, 0.0)):
    vals = {"tokens": np.array(list(first) + [0], np.int32),
            "active": np.array([True, True, False]),
            "temps": np.array(list(temps) + [0.0], np.float32),
            "budget": np.array(list(budget) + [0], np.int32),
            "eos": np.array(list(eos) + [-1], np.int32)}
    if pkg == "jax":
        st = jdec.init_decode_state(SLOTS, jax.random.PRNGKey(5))
        return dict(st, **{k: jnp.asarray(v) for k, v in vals.items()})
    st = tdec.init_decode_state(SLOTS, torch.Generator().manual_seed(5))
    return dict(st, **{k: _t(v) for k, v in vals.items()})


def _target(params, pkg, paged):
    return (_paged if paged else _dense)(params, TC if pkg == "torch" else CFG,
                                         pkg)


def _vanilla(tp, paged, first, n):
    """Greedy vanilla decode of both prompts in the port: [2, n] tokens
    after the first."""
    cache, _ = _target(tp, "torch", paged)
    step = tpd.paged_decode_step if paged else tdec.decode_step
    toks = torch.tensor(list(first) + [0], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    out = []
    for _ in range(n):
        cache, logits = step(tp, cache, toks, active, TC, torch.float32)
        toks = logits.argmax(-1).to(torch.int32)
        out.append(toks[:2].numpy())
    return np.stack(out, 1)


def _budgets_and_eos(vanilla):
    """Slot 0: a budget of 10 (clamped mid-window: ROUNDS*K = 20); slot 1:
    EOS = the first token of its vanilla stream from index 3 on that it has
    not emitted before (so the stream ends there, inside a window)."""
    seq = list(vanilla[1])
    i = next(i for i in range(3, len(seq)) if seq[i] not in seq[:i])
    return (10, 30), (-1, int(seq[i])), (10, i + 1)


def test_verify_window_matches_jax_across_max_len(params):
    """max_len 16: slot 0 holds 14 tokens, so its window's last two
    positions fall past the cache and are dropped (length clamps to 16);
    slot 1's window lies inside."""
    jp, _, tp, _ = params
    jc, _ = _dense(jp, CFG, "jax", 16)
    tcache, _ = _dense(tp, TC, "torch", 16)
    jc = dict(jc, length=jc["length"].at[0].set(14))
    tcache["length"][0] = 14
    window = np.array([[5, 6, 7, 8], [9, 10, 11, 12], [0, 0, 0, 0]],
                      np.int32)
    active = np.array([True, True, False])
    jc, jl = _jverify(jp, jc, jnp.asarray(window), jnp.asarray(active), CFG,
                      F32)
    tcache, tl = tspec.verify_window(tp, tcache, _t(window), _t(active), TC,
                                     torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=0)
    assert tcache["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [16, 6 + 4, 0]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_window_equals_sequential_decode_steps(params, paged):
    """A k-token window computes what k single-token steps compute: the
    same logits and the same cache rows of the active slots (an inactive
    slot's writes are garbage either way)."""
    _, _, tp, _ = params
    a, first = _target(tp, "torch", paged)
    b, _ = _target(tp, "torch", paged)
    window = np.array([[first[0], 7, 21, 3], [first[1], 9, 9, 1],
                       [0, 0, 0, 0]], np.int32)
    active = torch.tensor([True, True, False])
    verify = tspec.verify_window if not paged else tpd.paged_verify_window
    step = tdec.decode_step if not paged else tpd.paged_decode_step
    a, wl = verify(tp, a, _t(window), active, TC, torch.float32)
    for j in range(K):
        b, sl = step(tp, b, _t(window[:, j]), active, TC, torch.float32)
        np.testing.assert_allclose(wl[:, j].numpy(), sl.numpy(), atol=ATOL,
                                   rtol=0)
    assert a["length"].tolist() == b["length"].tolist()
    for key in ("k", "v"):
        if paged:
            got, want = (c[key][:, 1:2 * MAX_PAGES + 1] for c in (a, b))
        else:
            got, want = (c[key][:, :2] for c in (a, b))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_state_round_and_loop_match_jax_and_vanilla(params, paged):
    jp, jdp, tp, tdp = params
    jc, first = _target(jp, "jax", paged)
    tcache, tfirst = _target(tp, "torch", paged)
    np.testing.assert_array_equal(tfirst, first)
    vanilla = _vanilla(tp, paged, first, ROUNDS * K)
    budget, eos, want_counts = _budgets_and_eos(vanilla)

    def fresh():
        jd, _ = _dense(jdp, DCFG, "jax")
        td, _ = _dense(tdp, TDC, "torch")
        return (_target(jp, "jax", paged)[0], jd, _state("jax", first,
                                                         budget, eos),
                _target(tp, "torch", paged)[0], td,
                _state("torch", first, budget, eos))

    # one round
    jc, jd, js, tc, td, ts = fresh()
    jc, jd, js, jem, jn = _jround(jp, jc, jdp, jd, js, K, CFG, DCFG, paged,
                                  0, F32)
    tc, td, ts, tem, tn = tspec.spec_state_round(tp, tc, tdp, td, ts, K, TC,
                                                 TDC, paged, 0, torch.float32)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for s in range(2):
        n = int(jn[s])
        np.testing.assert_array_equal(tem[s, :n].numpy(),
                                      np.asarray(jem)[s, :n])
    for key in ("tokens", "active", "budget"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    np.testing.assert_array_equal(td["length"].numpy(),
                                  np.asarray(jd["length"]))

    # the loop
    jc, jd, js, tc, td, ts = fresh()
    jres = _jloop(jp, jc, jdp, jd, js, K, ROUNDS, CFG, DCFG, paged, 0, F32)
    tres = tspec.spec_decode_state_loop(tp, tc, tdp, td, ts, K, ROUNDS, TC,
                                        TDC, paged, 0, torch.float32)
    counts = tres["counts"].numpy()
    np.testing.assert_array_equal(counts, np.asarray(jres["counts"]))
    np.testing.assert_array_equal(tres["emit_counts"].numpy(),
                                  np.asarray(jres["emit_counts"]))
    assert counts.tolist() == [*want_counts, 0]
    for s in range(2):
        got = tres["tokens"][s, :counts[s]].numpy()
        np.testing.assert_array_equal(got,
                                      np.asarray(jres["tokens"])[s, :counts[s]])
        np.testing.assert_array_equal(got, vanilla[s, :counts[s]])
    assert not tres["state"]["active"].any()
    # both the accept and the reject path ran
    emits = tres["emit_counts"].numpy()[:, :2]
    assert (emits > 1).any() and ((emits >= 1) & (emits < K)).any()
    for key in ("target_cache", "draft_cache"):
        np.testing.assert_array_equal(
            tres[key]["length"].numpy(), np.asarray(jres[key]["length"]))


def test_sampled_slots_accept_no_drafts(params):
    """A slot at temperature > 0 accepts no drafts: one token a round,
    drawn from the target's own logits; the greedy slot beside it still
    accepts."""
    _, _, tp, tdp = params
    tc, first = _target(tp, "torch", True)
    td, _ = _dense(tdp, TDC, "torch")
    st = _state("torch", first, (30, 30), (-1, -1), temps=(0.8, 0.0))
    res = tspec.spec_decode_state_loop(tp, tc, tdp, td, st, K, ROUNDS, TC,
                                       TDC, True, 0, torch.float32)
    emits = res["emit_counts"].numpy()
    assert (emits[:, 0] == 1).all()
    assert res["counts"].tolist() == [ROUNDS, int(emits[:, 1].sum()), 0]
    assert emits[:, 1].max() > 1
    assert all(0 <= t < CFG.vocab_size for t in res["tokens"][0].tolist())


def test_speculative_decode_loop_matches_jax(params):
    """The standalone loop (bf16 compute, as the JAX package's) with an EOS
    that ends slot 0 early: the same tokens, counts and per-round
    acceptance as JAX's."""
    jp, jdp, tp, tdp = params
    jc, first = _dense(jp, CFG, "jax")
    jd, _ = _dense(jdp, DCFG, "jax")
    tcache, _ = _dense(tp, TC, "torch")
    td, _ = _dense(tdp, TDC, "torch")
    last = np.array(list(first) + [0], np.int32)
    active = np.array([True, True, False])
    probe = jspec.speculative_decode_loop(jp, jc, jdp, jd, jnp.asarray(last),
                                          jnp.asarray(active), K, 2, CFG,
                                          DCFG)
    eos = int(np.asarray(probe["tokens"])[0, 2])
    jc, _ = _dense(jp, CFG, "jax")
    jd, _ = _dense(jdp, DCFG, "jax")
    jres = jspec.speculative_decode_loop(jp, jc, jdp, jd, jnp.asarray(last),
                                         jnp.asarray(active), K, ROUNDS, CFG,
                                         DCFG, eos_id=eos)
    tres = tspec.speculative_decode_loop(tp, tcache, tdp, td, _t(last),
                                         _t(active), K, ROUNDS, TC, TDC,
                                         eos_id=eos)
    counts = tres["counts"].numpy()
    np.testing.assert_array_equal(counts, np.asarray(jres["counts"]))
    np.testing.assert_array_equal(tres["rounds_accepted"].numpy(),
                                  np.asarray(jres["rounds_accepted"]))
    np.testing.assert_array_equal(tres["active"].numpy(),
                                  np.asarray(jres["active"]))
    assert not tres["active"][0]
    for s in range(2):
        np.testing.assert_array_equal(
            tres["tokens"][s, :counts[s]].numpy(),
            np.asarray(jres["tokens"])[s, :counts[s]])


def test_draft_params_and_damping_match_jax(params):
    jp, jdp, tp, tdp = params
    raw = jtr.init_params(jax.random.PRNGKey(3), CFG, dtype=F32)
    damped = tspec.damp_block_outputs(
        params_from_numpy(jax.tree.map(np.asarray, raw), "cpu"), 0.2, 1)
    for tree_t, tree_j in ((damped, jp), (tdp, jdp)):
        flat_j = dict(jax.tree_util.tree_flatten_with_path(tree_j)[0])
        flat_t = dict(jax.tree_util.tree_flatten_with_path(tree_t)[0])
        assert flat_t.keys() == flat_j.keys()
        for path, leaf in flat_j.items():
            np.testing.assert_array_equal(flat_t[path].numpy(),
                                          np.asarray(leaf))
    # the draft shares the target's storage: views, no copy
    assert tdp["embed"]["tokens"] is tp["embed"]["tokens"]
    assert (tdp["blocks"]["attn"]["wq"].data_ptr()
            == tp["blocks"]["attn"]["wq"].data_ptr())
    assert tdp["blocks"]["attn"]["wq"].shape[0] == 1


def test_paged_rollback_matches_fresh_prefill(params):
    """After spec rounds with rejections and a budget clamp mid-window, the
    paged cache holds what a fresh prefill of the verified sequence writes:
    the same length and the same K/V at every live position (the cache
    covers the prompt and every emitted token but the last, which is fed
    back next round).

    The tolerance is 1e-5, not the 1e-6 of the JAX package's own version of
    this test (``tests/test_spec_serving.py``): K/V computed in a k-token
    verify window and in one prefill are the same f32 math summed in
    another order, and the JAX package's own run differs from its fresh
    prefill by 1.33e-6 there (1 of 1344 elements), which fails its 1e-6
    while the rollback logic is right."""
    _, _, tp, tdp = params
    prompt = list(PROMPTS[0])
    tc, first = _paged(tp, TC, "torch", [prompt])
    td, _ = _dense(tdp, TDC, "torch", prompts=[prompt])
    budget = 10
    st = _state("torch", [first[0], 0], (budget, 0), (-1, -1))
    st["active"][1] = False
    res = tspec.spec_decode_state_loop(tp, tc, tdp, td, st, K, ROUNDS, TC,
                                       TDC, True, 0, torch.float32)
    cnt = int(res["counts"][0])
    emitted = res["tokens"][0, :cnt].tolist()
    assert cnt == budget
    assert int(res["emit_counts"][:, 0].sum()) == cnt
    assert (res["emit_counts"][:, 0] < K).any()     # a rejection happened
    cache = res["target_cache"]
    verified = prompt + [int(first[0])] + emitted[:cnt - 1]
    assert int(cache["length"][0]) == len(verified) == len(prompt) + cnt

    fresh, _ = _paged(tp, TC, "torch", [verified])
    bt = cache["block_table"][0].numpy()
    pos = np.arange(len(verified))
    for key in ("k", "v"):
        got = cache[key].numpy()[:, bt[pos // PAGE], pos % PAGE]
        want = fresh[key].numpy()[:, bt[pos // PAGE], pos % PAGE]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
