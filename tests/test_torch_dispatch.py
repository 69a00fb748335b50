"""Which attention path a call takes: the flash kernel B1-B3 and the splash
kernel B4 take bf16, f16 and f32, so any other dtype takes plain attention
up front, as a softcap does, while the kernel wrappers keep raising on what
they do not take.  (tests/test_torch_attention_dtypes.py holds the f16 and
f32 routes to the kernels.)

The CPU tests check the dispatch predicates and the residual names the
model's attention step carries; they need no card.  The ``cuda`` tests run
an f32 engine and an f32 training step on the card through long sequences
and show that they launch the f32 kernels:

    python -m pytest --noconftest -m cuda tests/test_torch_dispatch.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import splash_attention as tsplash


@pytest.mark.parametrize("dtype,takes", [
    (torch.bfloat16, True), (torch.float64, False), (torch.int32, False)])
def test_flash_kernel_takes_bf16_only(dtype, takes):
    assert tattn.flash_kernel_takes(True, 1024, 128, 0.0, dtype) is takes


@pytest.mark.parametrize("is_cuda,seq,head_dim,softcap", [
    (False, 1024, 128, 0.0), (True, 1023, 128, 0.0), (True, 2048, 96, 0.0),
    (True, 2048, 128, 50.0)])
def test_flash_kernel_takes_no_other_bf16_call(is_cuda, seq, head_dim,
                                               softcap):
    assert not tattn.flash_kernel_takes(is_cuda, seq, head_dim, softcap,
                                        torch.bfloat16)


def _cfg(impl, softcap=0.0):
    return dataclasses.replace(tcfg.tiny(hidden=256, heads=2, seq=2048),
                               attention_impl=impl,
                               attn_logit_softcap=softcap)


# (attention_impl, is_cuda, dtype, seq) -> whether the flash kernel (or, on
# CPU tensors, its plain version through flash_attention) runs, which is
# when the step's residuals carry flash's names
_ROUTES = [
    ("auto", True, torch.bfloat16, 1024, True),
    ("auto", True, torch.float64, 1024, False),
    ("auto", True, torch.float64, 2048, False),
    ("auto", True, torch.bfloat16, 512, False),
    ("auto", False, torch.bfloat16, 1024, False),
    ("flash", True, torch.bfloat16, 1024, True),
    ("flash", True, torch.float64, 1024, False),
    ("flash", True, torch.float64, 128, False),
    ("flash", False, torch.float32, 1024, True),
    ("splash", True, torch.bfloat16, 1024, False),
    ("plain", True, torch.bfloat16, 1024, False),
]


@pytest.mark.parametrize("impl,is_cuda,dtype,seq,flash", _ROUTES)
def test_attention_step_names_follow_the_route(monkeypatch, impl, is_cuda,
                                               dtype, seq, flash):
    """``_attention_fn`` names flash's residuals exactly where
    flash_attention runs: "flash" on a CUDA tensor of a dtype the kernel
    does not take (f64) takes "auto"'s route (plain attention), as a
    softcap does.  The step is run on small CPU tensors of the same dtype
    with flash_attention spied on."""
    calls = []
    real = tflash.flash_attention
    monkeypatch.setattr(tsplash, "_warned", True)  # splash declines S=8
    monkeypatch.setattr(tflash, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    fn, names = ttr._attention_fn(_cfg(impl), seq, is_cuda, dtype)
    assert (names == ttr.FLASH_RESIDUALS) is flash
    if impl == "auto":
        return  # mha decides from the tensors themselves (tested below)
    # (the CPU has no f16 matmul; the route is fixed by now)
    run = torch.float32 if dtype == torch.float16 else dtype
    q, k, v = (torch.ones((1, 8, heads, 128), dtype=run)
               for heads in (2, 1, 1))
    fn(q, k, v)
    assert bool(calls) is flash


def test_attention_step_names_for_a_softcap():
    fn, names = ttr._attention_fn(_cfg("flash", 50.0), 1024, True,
                                  torch.bfloat16)
    assert names is None


def test_mha_sends_no_f32_call_to_the_kernel(monkeypatch):
    """mha reads the device and dtype off q and hands them to
    ``flash_kernel_takes``: an f32 call on CPU tensors goes to plain
    attention."""
    seen = []
    monkeypatch.setattr(tattn, "flash_kernel_takes",
                        lambda *a: seen.append(a) or False)
    q = torch.ones((1, 8, 2, 128))
    tattn.mha(q, q[:, :, :1], q[:, :, :1])
    assert seen == [(False, 8, 128, 0.0, torch.float32)]


@pytest.mark.parametrize("is_cuda,dtype,head_dim,reason", [
    (True, torch.bfloat16, 128, None),
    (True, torch.bfloat16, 256, None),
    (True, torch.float32, 128, None),
    (True, torch.float16, 256, None),
    (True, torch.bfloat16, 384, "head_dim=384"),
    (True, torch.bfloat16, 512, "head_dim=512"),
    (False, torch.float32, 384, None),
    (False, torch.bfloat16, 512, None),
])
def test_splash_kernel_declines(is_cuda, dtype, head_dim, reason):
    got = tsplash.splash_kernel_declines(is_cuda, dtype, head_dim)
    if reason is None:
        assert got is None
    else:
        assert reason in got


def test_splash_mha_declines_with_the_contract(monkeypatch):
    """A decline goes through the same contract as a shape that does not
    tile: one RuntimeWarning per process, then None."""
    monkeypatch.setattr(tsplash, "_warned", False)
    monkeypatch.setattr(tsplash, "splash_kernel_declines",
                        lambda *a: "the splash kernel takes bf16")
    q = torch.ones((1, 128, 2, 128))
    with pytest.warns(RuntimeWarning, match="takes bf16"):
        assert tsplash.splash_mha(q, q, q) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tsplash.splash_mha(q, q, q) is None


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches():
    return (tflash.flash_attention.launches,
            tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches,
            tsplash.splash_attention.launches,
            tsplash.splash_attention_bwd_dq.launches,
            tsplash.splash_attention_bwd_dkv.launches)


@pytest.mark.cuda
def test_f32_engine_prefills_a_long_bucket_on_card(cuda_device):
    """LLMEngine(compute_dtype=torch.float32) with a prompt in bucket 2048:
    the prefill runs B1 in f32 once per layer, and the engine returns its
    tokens."""
    from ray_tpu_torch.serve.llm import LLMEngine
    cfg = tcfg.tiny(hidden=256, heads=2, seq=2048)
    before = _launches()
    before_f32 = tflash.flash_attention.launches_by_dtype["f32"]
    eng = LLMEngine(cfg, num_slots=2, max_len=2048, seed=0,
                    compute_dtype=torch.float32, device=cuda_device)
    try:
        prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, 1100)
        toks = eng.generate(prompt.tolist(), max_tokens=2)
    finally:
        eng.shutdown()
    assert len(toks) == 2 and all(0 <= t < cfg.vocab_size for t in toks)
    assert eng.admit_batches_by_bucket.get(2048) == 1
    assert _launches() == (before[0] + cfg.num_layers, *before[1:])
    assert (tflash.flash_attention.launches_by_dtype["f32"]
            == before_f32 + cfg.num_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "flash", "splash"])
def test_f32_train_step_at_1024_on_card(cuda_device, impl):
    """An f32 training step at S=1024 on the card, through every
    attention_impl that reaches a kernel: it runs, its loss and gradient
    norm are finite, and the f32 kernels launch (B1-B3, or B4 with
    "splash") once per layer each, and the forward once more in full
    remat's replay."""
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)
    cfg = _cfg(impl)
    opt = make_optimizer(warmup_steps=1, total_steps=10)
    state, sh = init_sharded_state(cfg, None, opt, seed=0, device=cuda_device)
    step = make_train_step(cfg, None, opt, sh, compute_dtype=torch.float32,
                           device=cuda_device)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 1025)).astype(np.int32)}
    before = _launches()
    state, metrics = step(state, batch)
    assert np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item())
    n = cfg.num_layers  # full remat (the default) replays the forward
    want = ((0, 0, 0, 2 * n, n, n) if impl == "splash"
            else (2 * n, n, n, 0, 0, 0))
    assert tuple(a - b for a, b in zip(_launches(), before)) == want
