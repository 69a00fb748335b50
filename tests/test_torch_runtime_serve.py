"""The slice as a whole: the port's LLMEngine in an actor of the port's
runtime against the JAX package's engine in the test process.

JAX's tiny model (float32 params from ``PRNGKey(0)``, as numpy) goes
through ``ray_tpu_torch.put`` to an actor, which builds
``LLMEngine(cfg, params_from_numpy(...), device="cpu")``.  Four greedy
requests, queued in one go so both engines admit them in the same batches
(three prompts in bucket 32, one in bucket 64), stream the same tokens as
the reference's ``ray_tpu.serve.llm.LLMEngine``: dense and paged.  The
actor's streaming-generator method gives ``generate``'s tokens, and its
worker holds no module of JAX or of the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.serve import llm as jllm

PROMPT_LENS = (5, 9, 20, 40)
MAX_TOKENS = 8
ENGINE_KW = dict(num_slots=4, max_len=64)
ARMS = {"dense": {}, "paged": dict(paged=True, page_size=8)}
WAIT_S = 120


class EngineActor:
    """The port's engine on the CPU, inside a worker of the port's runtime.

    Defined here, so the runtime ships it by value; it names only
    ``ray_tpu_torch`` modules, which the worker imports itself."""

    def __init__(self, cfg_fields, params, kw):
        import torch

        from ray_tpu_torch.models.config import TransformerConfig
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.serve.llm import LLMEngine
        self.eng = LLMEngine(TransformerConfig(**cfg_fields),
                             params_from_numpy(params, "cpu"),
                             compute_dtype=torch.float32, device="cpu", **kw)

    def run(self, prompts, max_tokens):
        """Queue every request at once (one admit pass sees them all),
        then collect each stream."""
        from ray_tpu_torch.serve import llm
        reqs = [llm.GenRequest(list(p), max_tokens, 0.0, 0, None)
                for p in prompts]
        with self.eng._pending.mutex:
            self.eng._pending.queue.extend(reqs)
        self.eng._wake.set()
        return [_collect(r, llm._FLUSH) for r in reqs]

    def generate(self, prompt, max_tokens):
        return self.eng.generate(list(prompt), max_tokens=max_tokens)

    def stream(self, prompt, max_tokens):
        yield from self.eng.stream(list(prompt), max_tokens=max_tokens)

    def module_roots(self):
        import sys
        return sorted({m.split(".")[0] for m in sys.modules} & {
            "jax", "jaxlib", "ray_tpu", "ray_tpu_torch", "torch"})

    def engine_thread_alive_after_shutdown(self):
        self.eng.shutdown()
        self.eng._thread.join(timeout=30)
        return self.eng._thread.is_alive()


def _collect(req, flush, timeout=WAIT_S):
    toks = []
    while True:
        item = req.out.get(timeout=timeout)
        if item is flush:
            return toks
        if isinstance(item, BaseException):
            raise item
        toks.append(item)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def model():
    cfg = jcfg.tiny()
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def _reference_streams(cfg, params, prompts, kw):
    eng = jllm.LLMEngine(cfg, params, compute_dtype=jnp.float32,
                         **ENGINE_KW, **kw)
    try:
        reqs = [jllm.GenRequest(list(p), MAX_TOKENS, 0.0, 0, None)
                for p in prompts]
        with eng._pending.mutex:
            eng._pending.queue.extend(reqs)
        eng._wake.set()
        return [_collect(r, jllm._FLUSH) for r in reqs]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("arm", list(ARMS))
def test_actor_engine_streams_match_jax(model, runtime, arm):
    cfg, jparams, tree = model
    prompts = _prompts(cfg.vocab_size)
    want = _reference_streams(cfg, jparams, prompts, ARMS[arm])
    assert [len(t) for t in want] == [MAX_TOKENS] * len(prompts)

    # held until the constructor has run: the runtime, as the reference's,
    # does not pin an actor constructor's arguments for it
    params = ray_tpu_torch.put(tree)
    actor = ray_tpu_torch.remote(EngineActor).remote(
        dataclasses.asdict(cfg), params, dict(ENGINE_KW, **ARMS[arm]))
    try:
        got = ray_tpu_torch.get(actor.run.remote(prompts, MAX_TOKENS),
                                timeout=WAIT_S)
        assert got == want
        # the generator method streams one request's tokens as generate
        # returns them, item by item
        one = ray_tpu_torch.get(actor.generate.remote(prompts[2], MAX_TOKENS),
                                timeout=WAIT_S)
        gen = actor.stream.options(num_returns="streaming").remote(
            prompts[2], MAX_TOKENS)
        streamed = []
        while True:
            try:
                ref = gen.next(timeout=WAIT_S)
            except StopIteration:
                break
            streamed.append(ray_tpu_torch.get(ref, timeout=WAIT_S))
        assert streamed == one and len(one) == MAX_TOKENS
        # the worker holds the port and torch, nothing of JAX's side
        assert ray_tpu_torch.get(actor.module_roots.remote(),
                                 timeout=WAIT_S) == ["ray_tpu_torch", "torch"]
        assert not ray_tpu_torch.get(
            actor.engine_thread_alive_after_shutdown.remote(), timeout=WAIT_S)
    finally:
        ray_tpu_torch.kill(actor)
