"""The port's LLMEngine against the JAX package's, on the same params.

Both engines get the same float32 tiny model (JAX params carried over with
``params_from_numpy``) and the same four greedy requests, queued in one go
so both admit them in the same batches: three prompts in bucket 32, one in
bucket 64.  Streamed tokens must be identical, and so must ``breakdown()``.
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


@pytest.mark.parametrize("kw", [dict(paged=True), dict(tp=2),
                                dict(spec_decode_enabled=True)])
def test_not_ported_engine_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllm.LLMEngine(tcfg.tiny(), device="cpu", **kw)
