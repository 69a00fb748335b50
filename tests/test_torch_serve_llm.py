"""The port's LLMEngine against the JAX package's, on the same params.

Both engines get the same float32 tiny model (JAX params carried over with
``params_from_numpy``) and the same four greedy requests, queued in one go
so both admit them in the same batches: three prompts in bucket 32, one in
bucket 64.  Streamed tokens must be identical, and so must ``breakdown()``
(and ``prefix_digest()``): for the dense engine, and for the paged engine
alone, with prefix reuse (a second wave of prompts sharing the first
wave's three-page prefix) and with speculative decoding (a fixed k).
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
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve import llm as tllm

PROMPT_LENS = (5, 9, 20, 40)
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def tiny_model():
    cfg = jcfg.tiny()
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tree


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


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


def test_engine_streams_match_jax(tiny_model):
    cfg, jparams, tree = tiny_model
    prompts = _prompts(cfg.vocab_size)
    jeng = jllm.LLMEngine(cfg, jparams, num_slots=4, max_len=64,
                          compute_dtype=jnp.float32)
    try:
        want = _run(jeng, jllm, prompts)
        want_bd = jeng.breakdown()
    finally:
        jeng.shutdown()

    tc = tcfg.TransformerConfig(**dataclasses.asdict(cfg))
    teng = tllm.LLMEngine(tc, params_from_numpy(tree, "cpu"), num_slots=4,
                          max_len=64, compute_dtype=torch.float32,
                          device="cpu")
    try:
        got = _run(teng, tllm, prompts)
        got_bd = teng.breakdown()
    finally:
        teng.shutdown()
    assert not teng._thread.is_alive()

    assert [len(t) for t in got] == [MAX_TOKENS] * len(prompts)
    assert got == want
    assert got_bd == want_bd
    assert got_bd["admit_batches"] == 2


def test_engine_generate_and_stream(tiny_model):
    cfg, _, tree = tiny_model
    tc = tcfg.TransformerConfig(**dataclasses.asdict(cfg))
    eng = tllm.LLMEngine(tc, params_from_numpy(tree, "cpu"), num_slots=2,
                         max_len=32, compute_dtype=torch.float32,
                         device="cpu", steps_per_dispatch=3, fetch_lag=0)
    try:
        eng.warmup()
        out = eng.generate([1, 2, 3], max_tokens=5)
        assert len(out) == 5 and all(0 <= t < tc.vocab_size for t in out)
        # a request near max_len stops at max_len, not at max_tokens
        long = eng.generate(list(range(1, 30)), max_tokens=10)
        assert len(long) == 32 - 29
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(list(range(40)))
    finally:
        eng.shutdown()


def test_prefill_error_reaches_the_caller(tiny_model):
    cfg, _, tree = tiny_model
    tc = tcfg.TransformerConfig(**dataclasses.asdict(cfg))
    params = params_from_numpy(tree, "cpu")
    del params["blocks"]["mlp"]["w_gate"]
    eng = tllm.LLMEngine(tc, params, num_slots=2, max_len=32,
                         compute_dtype=torch.float32, device="cpu")
    try:
        with pytest.raises(KeyError, match="w_gate"):
            eng.generate([1, 2, 3], max_tokens=2)
        assert sorted(eng._free_slots) == [0, 1]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [dict(tp=2)])
def test_not_ported_engine_options_raise(kw):
    """Options once refused now run: at tp=2 the engine draws tp=1's
    params from the seed, splits them over two shards on the CPU and
    streams tp=1's greedy tokens.  A tp that does not divide the KV heads
    raises the reference's ValueError."""
    outs = []
    for opts in ({}, kw):
        eng = tllm.LLMEngine(tcfg.tiny(), device="cpu", num_slots=2,
                             max_len=32, compute_dtype=torch.float32, **opts)
        try:
            outs.append(eng.generate([3, 1, 4, 1, 5], max_tokens=6))
            assert isinstance(eng.params, list) == bool(opts)
        finally:
            eng.shutdown()
    assert len(outs[0]) == 6 and outs[1] == outs[0]
    with pytest.raises(ValueError, match="must divide num_kv_heads"):
        tllm.LLMEngine(tcfg.tiny(), device="cpu", tp=kw["tp"] + 1)


def test_spec_with_tp_raises_the_references_error():
    with pytest.raises(ValueError, match="does not compose with tp>1"):
        tllm.LLMEngine(tcfg.tiny(), device="cpu", tp=2,
                       spec_decode_enabled=True)


@pytest.mark.parametrize("kw", [dict(paged=True),
                                dict(spec_decode_enabled=True),
                                dict(paged=True, spec_decode_enabled=True)])
def test_paged_and_spec_engines_without_device_need_a_card(kw, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllm.LLMEngine(tcfg.tiny(), **kw)


PAGED = dict(paged=True, page_size=8)
ARMS = {
    "paged": PAGED,
    "paged_prefix": PAGED,
    # a fixed k: the adaptive controller would compile one JAX program
    # per window size
    "paged_spec": dict(PAGED, spec_decode_enabled=True, spec_k=4,
                       spec_draft_layers=1, spec_adaptive=False),
}


def _waves(arm, vocab):
    """The requests of one arm, in waves run one after the other: the
    prefix arm's second wave shares the first wave's 24-token (three-page)
    prefix and hits the prefix cache."""
    if arm != "paged_prefix":
        return [_prompts(vocab)]
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, vocab, 24).tolist()
    return [[prefix + rng.integers(1, vocab, n).tolist() for n in (3, 6)]
            for _ in range(2)]


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_paged_engines_stream_what_jax_streams(tiny_model, arm):
    cfg, jparams, tree = tiny_model
    waves = _waves(arm, cfg.vocab_size)
    got = {}
    for name, mod in (("jax", jllm), ("torch", tllm)):
        if name == "jax":
            eng = jllm.LLMEngine(cfg, jparams, num_slots=4, max_len=64,
                                 compute_dtype=jnp.float32, **ARMS[arm])
        else:
            eng = tllm.LLMEngine(
                tcfg.TransformerConfig(**dataclasses.asdict(cfg)),
                params_from_numpy(tree, "cpu"), num_slots=4, max_len=64,
                compute_dtype=torch.float32, device="cpu", **ARMS[arm])
        try:
            outs = [_run(eng, mod, w) for w in waves]
            got[name] = (outs, eng.breakdown(), eng.prefix_digest())
        finally:
            eng.shutdown()
    assert got["torch"] == got["jax"]
    outs, bd, digest = got["torch"]
    assert [len(t) for w in outs for t in w] == [MAX_TOKENS] * sum(
        map(len, waves))
    assert bd["kv_pages"]["used"] == bd["prefix_cache"]["cached_pages"]
    assert digest["page"] == 8 and digest["blocks"]
    if arm == "paged_prefix":
        assert bd["prefix_cache"]["hits"] == 2
        assert bd["prefix_cache"]["tokens_reused"] == 2 * 24
    if arm == "paged_spec":
        sp = bd["spec"]
        assert sp["draft_errors"] == 0 and sp["dispatch_k"].keys() == {4}
        # every streamed token but each request's first (the prefill's)
        assert sp["tokens"] == len(waves[0]) * (MAX_TOKENS - 1)
        assert 0 < sp["accepted"] < sp["drafted"]


def test_paged_backpressure_requeues(tiny_model):
    """An arena of 7 usable pages holds one request of 5 pages at a time:
    the second is requeued until the first retires (two admit batches),
    then streams what it streams alone."""
    cfg, _, tree = tiny_model
    tc = tcfg.TransformerConfig(**dataclasses.asdict(cfg))
    kw = dict(num_slots=4, max_len=64, compute_dtype=torch.float32,
              device="cpu", steps_per_dispatch=2, paged=True, page_size=8,
              prefix_cache=False)
    prompts = [[1] * 12, [2] * 12]       # 12 + 20 + 1 tokens: 5 pages each
    eng = tllm.LLMEngine(tc, params_from_numpy(tree, "cpu"), num_pages=8,
                         **kw)
    try:
        reqs = [tllm.GenRequest(list(p), 20, 0.0, 0, None) for p in prompts]
        with eng._pending.mutex:
            eng._pending.queue.extend(reqs)
        eng._wake.set()
        outs = [list(_stream(r)) for r in reqs]
        bd = eng.breakdown()
    finally:
        eng.shutdown()
    assert bd["admit_batches"] == 2
    assert bd["kv_pages"] == {"total": 7, "used": 0, "utilization": 0.0}
    alone = tllm.LLMEngine(tc, params_from_numpy(tree, "cpu"), **kw)
    try:
        assert alone.generate(prompts[1], max_tokens=20) == outs[1]
    finally:
        alone.shutdown()
    assert [len(o) for o in outs] == [20, 20]


def _stream(r, timeout=120.0):
    while True:
        item = r.out.get(timeout=timeout)
        if item is tllm._FLUSH:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
