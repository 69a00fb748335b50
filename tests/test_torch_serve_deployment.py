"""The port's LLM deployment (``ray_tpu_torch.serve.llm``) against the JAX
package's ``LLMServer``.

JAX's tiny model (float32 params from ``PRNGKey(0)``), carried over with
``params_from_numpy``, goes to the port's ``llm_deployment("tiny",
num_slots=4, max_len=64)`` as ``engine_kwargs={"params": ...,
"device": "cpu", "compute_dtype": torch.float32}``, deployed on the port's
runtime; the reference's ``ray_tpu.serve.llm.LLMServer`` runs in this
process on JAX's params, its requests tagged with the same deployment
name, as its replica would tag them.  Greedy requests go one after
another (so both engines see the same batches), some sharing a two-page
prefix: dense, and paged with the prefix cache on.  The streams, the
``stats()`` keys and counts, ``prefix_digest()`` and the engine hooks'
counters (tokens in and out, the engine TTFT and TPOT sample counts,
admit batches, prefix lookups and tokens reused) must equal the
reference's.  The replica class is ``LLMServer`` with one reader added
for its process's counters (``HookReader``); everything else is
``llm_deployment``'s.  Then one request over HTTP renders the span chain
proxy_recv -> router_queue -> replica -> batch_wait -> prefill -> decode,
found by ``tests/test_serve_observability.py``'s own ``_find_chain``.
Last, a burst of submits to the port's engine, with the hooks on, is
one admit batch.
"""

import asyncio
import dataclasses
import importlib.util
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import observability as jobs
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch import serve
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import LLMServer, llm_deployment

ROOT = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(num_slots=4, max_len=64)
ARMS = {"dense": {}, "paged": dict(paged=True, page_size=8)}
MAX_TOKENS = 8
WAIT_S = 120
#: the deployment's name, as ``llm_deployment("tiny")`` gives it
DEPLOYMENT = "llm-tiny"
#: the serve metrics the engine's hooks write (``serve/observability.py``)
HOOK_METRICS = ("raytpu_serve_tokens_total", "raytpu_serve_ttft_seconds",
                "raytpu_serve_tpot_seconds", "raytpu_serve_batch_size",
                "raytpu_serve_prefix_cache_lookups_total",
                "raytpu_serve_prefix_cache_tokens_reused_total")


def hook_reader():
    """-> (``LLMServer`` with a reader of its process's hook counters
    added, the reader itself).  Made in a function, so that cloudpickle
    ships the class by value: a replica cannot import this file."""

    def counters(get_metric):
        """The hooks' counters in one process's registry: counter values,
        and histogram sample counts, by metric and tags (the engine's TTFT
        only: the replica records one of its own)."""
        out = {}
        for name in HOOK_METRICS:
            m = get_metric(name)
            if m is None:
                continue
            snap = m.snapshot()
            for key, v in snap.get("values", snap.get("count", {})).items():
                if ("stage", "replica") not in key:
                    out[f"{name}{sorted(key)}"] = v
        return out

    class HookReader(LLMServer):
        def hook_counters(self):
            from ray_tpu_torch.util.metrics import get_metric
            return counters(get_metric)

    return HookReader, counters


HookReader, hook_counters = hook_reader()


def _prompts(vocab):
    """Six prompts, three of them opening with the same 16 tokens (two
    pages of 8): the later two hit the prefix cache."""
    rng = np.random.default_rng(3)
    shared = rng.integers(1, vocab, 16).tolist()
    tail = [rng.integers(1, vocab, n).tolist() for n in (4, 9, 20)]
    return [rng.integers(1, vocab, 5).tolist(), shared + tail[0],
            rng.integers(1, vocab, 40).tolist(), shared + tail[1],
            rng.integers(1, vocab, 20).tolist(), shared + tail[2]]


def _body(prompt):
    return {"tokens": list(prompt), "max_tokens": MAX_TOKENS}


@pytest.fixture(scope="module")
def model():
    cfg = jcfg.tiny()
    params = jtr.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 << 20)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _reference(jparams, prompts, arm):
    """The reference's LLMServer in this process, the requests one after
    another under the deployment's tag: -> streams, stats, digest, the
    hooks' counters this run added."""
    server = jllm.LLMServer("tiny", **ENGINE_KW, engine_kwargs=dict(
        params=jparams, compute_dtype=jnp.float32, **ARMS[arm]))

    async def one(prompt):
        token = jobs.set_current_deployment(DEPLOYMENT)
        try:
            return [t async for t in server(_body(prompt))]
        finally:
            jobs.reset_current_deployment(token)

    before = hook_counters(jmetrics.get_metric)
    try:
        streams = [asyncio.run(one(p)) for p in prompts]
        after = hook_counters(jmetrics.get_metric)
        return {"streams": streams, "stats": server.stats(),
                "digest": server.prefix_digest(),
                "hooks": {k: v - before.get(k, 0) for k, v in after.items()
                          if v != before.get(k, 0)}}
    finally:
        server.engine.shutdown()


@pytest.fixture(scope="module", params=list(ARMS))
def arm(request, model, runtime):
    """Both sides of one arm: the port's deployment on the runtime and the
    reference's server in this process."""
    cfg, jparams, tree = model
    prompts = _prompts(cfg.vocab_size)
    want = _reference(jparams, prompts, request.param)
    dep = llm_deployment("tiny", **ENGINE_KW, engine_kwargs=dict(
        params=params_from_numpy(tree, "cpu"), device="cpu",
        compute_dtype=torch.float32, **ARMS[request.param]))
    assert dep.name == DEPLOYMENT
    h = serve.run(dataclasses.replace(dep, func_or_class=HookReader),
                  timeout_s=WAIT_S)
    try:
        got = {"streams": [list(h.stream(_body(p), timeout_s=WAIT_S))
                           for p in prompts],
               "stats": h.stats.remote().result(timeout_s=WAIT_S),
               "digest": h.prefix_digest.remote().result(timeout_s=WAIT_S),
               "hooks": h.hook_counters.remote().result(timeout_s=WAIT_S)}
    finally:
        serve.shutdown()
    return request.param, got, want


def test_tiny_presets_agree():
    assert dataclasses.asdict(tcfg.tiny()) == dataclasses.asdict(jcfg.tiny())


def test_streams_equal_the_reference(arm):
    _, got, want = arm
    assert [len(s) for s in want["streams"]] == [MAX_TOKENS] * 6
    assert got["streams"] == want["streams"]


def test_stats_equal_the_reference(arm):
    name, got, want = arm
    assert set(got["stats"]) == set(want["stats"])
    assert got["stats"] == want["stats"]
    assert got["stats"]["tokens_out"] == 6 * MAX_TOKENS
    if name == "paged":
        assert got["stats"]["prefix_cache"]["hits"] == 2


def test_prefix_digest_equals_the_reference(arm):
    name, got, want = arm
    assert got["digest"] == want["digest"]
    assert (got["digest"] is None) == (name == "dense")


def test_hook_counters_equal_the_reference(arm):
    name, got, want = arm
    assert got["hooks"] == want["hooks"]
    tags = f"[('deployment', '{DEPLOYMENT}')"
    hooks = got["hooks"]
    assert hooks[f"raytpu_serve_tokens_total{tags}, ('direction', 'out')]"
                 ] == 6 * MAX_TOKENS
    assert hooks[f"raytpu_serve_ttft_seconds{tags}, ('stage', 'engine')]"
                 ] == 6
    assert hooks[f"raytpu_serve_tpot_seconds{tags}]"] == 6
    hits = f"raytpu_serve_prefix_cache_lookups_total{tags}, ('result', 'hit')]"
    assert hooks.get(hits) == (2 if name == "paged" else None)


def _observability_reference():
    """``tests/test_serve_observability.py`` as a module: its span-chain
    finder and its streaming POST."""
    path = ROOT / "tests" / "test_serve_observability.py"
    spec = importlib.util.spec_from_file_location("serve_observability_ref",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_http_request_renders_the_span_chain(model, runtime):
    """One HTTP request through the port's proxy, router, replica and
    engine is one connected trace, as the reference's test checks it."""
    ref = _observability_reference()
    _, _, tree = model
    dep = llm_deployment("tiny", **ENGINE_KW, route_prefix="/llm",
                         engine_kwargs=dict(
                             params=params_from_numpy(tree, "cpu"),
                             device="cpu", compute_dtype=torch.float32))
    try:
        serve.run(dep, timeout_s=WAIT_S, http=True)
        cfg = serve.http_config()
        ref._post_stream(f"http://{cfg['host']}:{cfg['port']}")
        deadline = time.monotonic() + 45
        chain, evs = None, []
        while time.monotonic() < deadline and chain is None:
            evs = ray_tpu_torch.timeline()
            chain = ref._find_chain(evs)
            if chain is None:
                time.sleep(0.5)
    finally:
        serve.shutdown()
    assert chain is not None, (
        f"no connected chain in {len(evs)} events; spans seen: "
        f"{sorted(ref._span_index(evs))}")
    assert len({e.get("trace_id") for e in chain}) == 1
    assert chain[3]["attributes"]["deployment"] == DEPLOYMENT


def test_burst_of_submits_is_one_admit_batch():
    """Five prompts of one bucket submitted back to back from one thread,
    with the hooks on, go in one prefill batch.  The scheduler thread
    admits whatever is pending when it wakes, so this holds only while
    ``submit`` makes no call that blocks (ROADMAP C13): the switch
    interval is raised for the burst, so that nothing else hands the
    scheduler the GIL before the last submit.  A call that releases the
    GIL only for a few microseconds (``os.urandom``) does not split the
    burst on a CPU host; it did on the H100's."""
    import sys

    from ray_tpu_torch.serve import observability as tobs
    from ray_tpu_torch.serve.llm import LLMEngine

    assert tobs.enabled()
    cfg = tcfg.tiny()
    eng = LLMEngine(cfg, num_slots=8, max_len=64, device="cpu",
                    compute_dtype=torch.float32)
    try:
        rng = np.random.default_rng(5)
        eng.generate(rng.integers(1, cfg.vocab_size, 20).tolist(),
                     max_tokens=2)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (17, 20, 24, 28, 31)]
        before = dict(eng.admit_batches_by_bucket)
        rows_before = eng.admit_rows_real
        interval = sys.getswitchinterval()
        sys.setswitchinterval(10.0)
        try:
            time.sleep(0.05)  # the scheduler back in its wait
            reqs = [eng.submit(p, max_tokens=2) for p in prompts]
        finally:
            sys.setswitchinterval(interval)
        for r in reqs:
            toks = []
            while isinstance(item := r.out.get(timeout=WAIT_S), int):
                toks.append(item)
            if isinstance(item, BaseException):
                raise item
            assert len(toks) == 2
        assert eng.admit_batches_by_bucket[32] - before.get(32, 0) == 1
        assert eng.admit_rows_real - rows_before == len(prompts)
    finally:
        eng.shutdown()
