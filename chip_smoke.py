#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each prints its seconds, and any failure raises and the
script exits non-zero:

1. The card's name and power limit (``nvidia-smi``); TF32 off for float32
   matmuls and convolutions, so the plain versions compute in full f32.
2. Build every CUDA source of the port with nvcc (all at once), timed.
3. Kernel B1 (flash forward) against its plain PyTorch version on the card,
   at the shapes the serving path gives it (Llama-3-8B prefill: B=8,
   S=2048 and S=1024, H=32, KV=8, D=128, causal), plus D=64 non-causal,
   D=256 and a ragged S.  Times of the kernel, the plain version and one
   library call (``scaled_dot_product_attention``, a yardstick the port
   never calls) with CUDA events, beside the least time the card could take
   (bound).
4. Kernels B2 (dq) and B3 (dk/dv) against their plain versions on the same
   residuals, at the training path's shape (llama_1b: B=8, S=2048, H=16,
   KV=8, D=128, causal) and the serving shape (B=8, S=1024, H=32, KV=8),
   plus D=64 non-causal with KV=H, D=256 and a ragged S; each run twice and
   required to give the same bits.  Times beside the bounds, the plain
   versions' and the backward of ``scaled_dot_product_attention`` (one
   library call for B2 + B3 together).
5. The serving path at full width: ``LLMEngine`` on Llama-3-8B (32 layers,
   hidden 4096, random bf16 weights from seed 0), 8 concurrent requests, 5
   with prompts of 1100-1900 tokens (bucket 2048, through the flash kernel)
   and 3 short ones (plain attention), 16 tokens each.  Launch counts are
   zeroed just before and read just after.  Then the prefill logits of one
   batch through the kernel against the same prefill through the kernel's
   plain version, and where the time of one prefill batch and one decode
   dispatch goes (torch.profiler).
6. The training path at full width: ``make_optimizer`` /
   ``init_sharded_state`` / ``make_train_step`` on llama_1b (16 layers,
   hidden 2048, 16 q / 8 kv heads, vocab 32768; fp32 params and Adam state,
   bf16 compute, remat), 8 steps on one batch of 8 x 2049 tokens from numpy
   seed 0.  Launch counts are zeroed just before and read just after: B1
   twice per layer and step (forward and remat replay), B2 and B3 once.
   Loss finite and falling; one step's loss and gradients through the
   kernels against the same step through the kernels' plain versions; the
   chunked LM-head loss timed alone; one step profiled (torch.profiler).
7. A JSON line of kernels, then the contract line
   ``{"ok": true, "device": {...}}`` as the last line of output.

Exits non-zero without a result when there is no CUDA card, or when the
``ray_tpu_torch`` package is not beside this script.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

OUT_ATOL = 2e-2      # bf16 out: P rounds to bf16 at other tile boundaries
LSE_ATOL = 1e-3      # f32 lse: same terms summed in another order
# bf16 dq/dk/dv of B2/B3 against their plain versions, as a share of the
# plain version's largest magnitude: P and dS round to bf16 at other tile
# boundaries and f32 sums run in another order
GRAD_RTOL = 2e-2
# one llama_1b training step (16 bf16 layers, fp32 params), attention
# through the kernels against attention through their plain versions: the
# loss within this absolute difference, every gradient leaf within this
# relative L2 difference (bf16 rounding of P / dS at other tile boundaries
# reaches every layer's gradient through the residual stream; the loss, a
# mean over 16k tokens, differed by 1.2e-5 on an H100)
STEP_LOSS_ATOL = 2e-4
STEP_GRAD_REL_L2 = 5e-2
# prefill logits through 32 bf16 layers, kernel vs plain version, as a
# share of the logits' std: the rms and the largest of 2 x 128256 differences
LOGITS_RMS = 0.05
LOGITS_MAX = 0.25

TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS, TRAIN_UNTIMED = 8, 2

LONG_PROMPTS = (1100, 1300, 1500, 1700, 1900)
SHORT_PROMPTS = (40, 50, 60)
MAX_TOKENS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(b, s, h, kv, d, causal):
    """Least time for the work this input needs: q.k and p.v over the
    (q, k) pairs the mask keeps, at the bf16 tensor-core peak, against
    q/k/v read once and out (bf16) + lse (f32) written once, at the HBM
    rate."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d) + 4 * b * h * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_call(q, k, v, causal):
    """One library call computing the same function on the same inputs
    (layout change made outside the timed call)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def check_flash(dev):
    """Phase 3: the flash kernel against its plain version."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    cases = [  # (B, S, H, KV, D, causal, timed)
        (8, 2048, 32, 8, 128, True, True),    # bucket-2048 prefill batch
        (8, 1024, 32, 8, 128, True, True),    # bucket-1024 prefill batch
        (8, 2048, 16, 8, 128, True, True),    # llama_1b training batch
        (2, 1024, 16, 4, 64, False, False),
        (2, 1000, 32, 8, 128, True, False),   # ragged edge
        (1, 1024, 8, 2, 256, True, False),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for b, s, h, kv, d, causal, timed in cases:
        q = torch.randn((b, s, h, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((b, s, kv, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((b, s, kv, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        out, lse = fa._flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        bound, bound_by = attention_bound_ms(b, s, h, kv, d, causal)
        row = {"shape": [b, s, h, kv, d], "causal": causal,
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "bound_ms": bound, "bound_by": bound_by}
        if timed:
            row["ms"] = time_ms(lambda: fa._flash_fwd(q, k, v, causal), 10)
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal), 3, 1)
            row["library_ms"] = time_ms(sdpa_call(q, k, v, causal), 10)
        log("flash_attention_fwd " + json.dumps(row))
        if not (err <= OUT_ATOL and lse_err <= LSE_ATOL):
            raise AssertionError(
                f"flash kernel disagrees with its plain version at "
                f"{row['shape']} causal={causal}: out {err} (atol {OUT_ATOL})"
                f", lse {lse_err} (atol {LSE_ATOL})")
        results.append(row)
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return results


def attention_bwd_bounds_ms(b, s, h, kv, d, causal):
    """Least times of B2 and B3 for the work this input needs: B2 does
    S = Q.K^T, dP = dO.V^T and dS.K (6 operations per (q, k) pair and
    head dim), B3 S^T, dP^T, P^T.dO and dS^T.Q (8), at the bf16
    tensor-core peak; against q, k, v, dO (bf16) and lse, Delta (f32) read
    once and dq (B2) or dk, dv (B3) written once, at the HBM rate."""
    pairs = s * (s + 1) // 2 if causal else s * s
    q_bytes, kv_bytes, stat_bytes = 2 * b * s * h * d, 2 * b * s * kv * d, \
        4 * b * h * s
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes
    out = {}
    for name, ops, writes in (("dq", 6, q_bytes), ("dkv", 8, 2 * kv_bytes)):
        t_ops = ops * b * h * d * pairs / PEAK_BF16_FLOPS * 1e3
        t_bytes = (reads + writes) / PEAK_BYTES_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def sdpa_bwd_call(q, k, v, dout, causal):
    """The backward of one library call computing the same function
    (``scaled_dot_product_attention`` with GQA), after an untimed forward:
    dq, dk and dv together, so a yardstick for B2 + B3."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), g,
                                       retain_graph=True)


def check_flash_bwd(dev):
    """Phase 4: B2 and B3 against their plain versions."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    cases = [  # (B, S, H, KV, D, causal, timed)
        (8, 2048, 16, 8, 128, True, True),    # llama_1b training batch
        (8, 1024, 32, 8, 128, True, True),    # serving shape, reps 4
        (2, 1024, 16, 16, 64, False, False),
        (1, 1024, 8, 2, 256, True, False),
        (2, 1000, 32, 8, 128, True, False),   # ragged edge
    ]
    gen = torch.Generator(device=dev).manual_seed(1)
    results = []
    for b, s, h, kv, d, causal, timed in cases:
        q, k, v, dout = (torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16)
                         for shape in ((b, s, h, d), (b, s, kv, d),
                                       (b, s, kv, d), (b, s, h, d)))
        out, lse = fa._flash_fwd(q, k, v, causal)
        delta = fa._delta(out, dout)

        def kernels():
            return (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                              causal),
                    *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                causal))

        got = kernels()
        again = kernels()
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        args = fa._bwd_reference_args(q, k, v, out, lse, dout, causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                causal)
        bounds = attention_bwd_bounds_ms(b, s, h, kv, d, causal)
        row = {"shape": [b, s, h, kv, d], "causal": causal,
               "bitwise_repeatable": same_bits}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - w.float()).abs().max().item()
            row[f"{name}_max_abs_err"] = diff
            row[f"{name}_rel_err"] = diff / w.float().abs().max().item()
            row[f"{name}_finite"] = bool(torch.isfinite(a).all())
        for name in ("dq", "dkv"):
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bounds[name]
        if timed:
            row["dq_ms"] = time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, dout, lse, delta, causal), 10)
            row["dkv_ms"] = time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, dout, lse, delta, causal), 10)
            row["delta_ms"] = time_ms(lambda: fa._delta(out, dout), 10)
            row["dq_plain_ms"] = time_ms(
                lambda: fa._bwd_dq_reference(*args), 3, 1)
            row["dkv_plain_ms"] = time_ms(
                lambda: fa._bwd_dkv_reference(*args), 3, 1)
            row["sdpa_bwd_ms"] = time_ms(
                sdpa_bwd_call(q, k, v, dout, causal), 10)
        log("flash_attention_bwd " + json.dumps(row))
        bad = [n for n in ("dq", "dk", "dv")
               if not (row[f"{n}_finite"] and row[f"{n}_rel_err"] <= GRAD_RTOL)]
        if bad or not same_bits:
            raise AssertionError(
                f"backward kernels at {row['shape']} causal={causal}: "
                f"{bad} exceed {GRAD_RTOL} of the plain version's largest "
                f"magnitude (or are not finite); bitwise repeatable: "
                f"{same_bits}")
        results.append(row)
        del q, k, v, dout, out, lse, delta, got, again, want, args
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def patched(module, name: str, fn):
    """Route ``module.name`` (an attention entry point) through ``fn`` for
    one comparison run, then restore it."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def serve_llama(dev):
    """Phase 5: the serving path at full width."""
    import numpy as np
    import torch
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = mcfg.llama3_8b()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, device="cuda", num_slots=8, max_len=2048, seed=0)
    torch.cuda.synchronize()
    log(f"engine up (random bf16 weights, {cfg.num_params() / 1e9:.2f} B "
        f"params): {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in LONG_PROMPTS + SHORT_PROMPTS]
    try:
        # first use of each bucket (cuBLAS heuristics, allocator growth)
        # stays out of the measured run
        for n in (LONG_PROMPTS[0], SHORT_PROMPTS[0]):
            eng.generate(prompts[0][:n], max_tokens=2)
        batches_before = dict(eng.admit_batches_by_bucket)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t_submit = time.monotonic()
        reqs = [eng.submit(p, max_tokens=MAX_TOKENS) for p in prompts]
        outs = []
        for r in reqs:
            toks = []
            while True:
                item = r.out.get(timeout=600)
                if isinstance(item, BaseException):
                    raise item
                if not isinstance(item, int):
                    break
                toks.append(item)
            outs.append(toks)
        t_done = time.monotonic()
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        long_batches = sum(
            n - batches_before.get(bk, 0)
            for bk, n in eng.admit_batches_by_bucket.items() if bk >= 1024)
    finally:
        eng.shutdown()

    for p, toks in zip(prompts, outs):
        if len(toks) != MAX_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"prompt of {len(p)} tokens returned "
                                 f"{len(toks)} tokens: {toks}")
    if long_batches < 1 or launches < cfg.num_layers * long_batches:
        raise AssertionError(
            f"flash kernel launched {launches} times for {long_batches} "
            f"prefill batches at bucket >= 1024 ({cfg.num_layers} layers)")
    ttft = sorted((r.first_token_at - t_submit) * 1e3 for r in reqs)
    first = min(r.first_token_at for r in reqs)
    stats = {
        "requests": len(reqs), "tokens_out": sum(map(len, outs)),
        "long_prefill_batches": long_batches, "flash_launches": launches,
        "ttft_ms": ttft, "ttft_ms_p50": ttft[len(ttft) // 2],
        "decode_tok_s": sum(len(t) - 1 for t in outs) / (t_done - first),
        "wall_s": t_done - t_submit, "peak_mem_gb": peak / 1e9,
    }
    log("serve " + json.dumps(stats))
    check_prefill_logits(eng, cfg, prompts, dev)
    where_time_goes(eng, cfg, prompts, dev)
    return stats, launches


def _prefill_batch(cfg, prompts, batch, dev):
    import numpy as np
    import torch
    bucket = 2048
    toks = np.zeros((batch, bucket), np.int32)
    lens = []
    for i in range(batch):
        p = prompts[i % len(LONG_PROMPTS)]
        toks[i, :len(p)] = p
        lens.append(len(p))
    return (torch.from_numpy(toks).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            torch.arange(batch, dtype=torch.int32, device=dev))


def check_prefill_logits(eng, cfg, prompts, dev):
    """Prefill logits of one batch (two long prompts, bucket 2048) through
    the kernel, against the same prefill with attention through the
    kernel's plain version, and (for scale) through plain attention."""
    import torch
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import flash_attention as fa

    toks, lengths, slots = _prefill_batch(cfg, prompts, 2, dev)
    with torch.inference_mode():
        cache = dec.init_kv_cache(cfg, 2, 2048, torch.bfloat16, dev)
        _, kern = dec.prefill(eng.params, cache, toks, lengths, slots, cfg)
        with patched(attention, "mha",
                     lambda q, k, v, causal=True, logit_softcap=0.0:
                     fa.flash_attention_reference(q, k, v, causal)[0]):
            _, ref = dec.prefill(eng.params, cache, toks, lengths, slots, cfg)
        with patched(attention, "mha",
                     lambda q, k, v, causal=True, logit_softcap=0.0:
                     attention.attend(q, k, v, causal=causal)):
            _, plain = dec.prefill(eng.params, cache, toks, lengths, slots,
                                   cfg)
    spread = ref.std().item()

    def rms(a, b):
        return (a - b).pow(2).mean().sqrt().item()

    row = {"std": spread,
           "rms_diff_plain_version": rms(kern, ref),
           "max_abs_diff_plain_version": (kern - ref).abs().max().item(),
           "rms_diff_plain_attention": rms(kern, plain),
           "rms_diff_plain_version_vs_plain_attention": rms(ref, plain),
           "argmax_agree": (kern.argmax(-1) == ref.argmax(-1)).float()
           .mean().item(),
           "finite": bool(torch.isfinite(kern).all())}
    log("prefill_logits " + json.dumps(row))
    if not (row["finite"]
            and row["rms_diff_plain_version"] <= LOGITS_RMS * spread
            and row["max_abs_diff_plain_version"] <= LOGITS_MAX * spread):
        raise AssertionError(
            f"prefill logits through the kernel differ from the plain "
            f"version's by rms {row['rms_diff_plain_version']}, max "
            f"{row['max_abs_diff_plain_version']} (limits {LOGITS_RMS}, "
            f"{LOGITS_MAX} x std {spread})")


def where_time_goes(eng, cfg, prompts, dev):
    """One prefill batch (8 x bucket 2048) and one decode dispatch (8 steps,
    8 slots), each timed with a synchronize and traced once with
    torch.profiler: device-busy share and the kernels that take the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.models import decode as dec

    toks, lengths, slots = _prefill_batch(cfg, prompts, 8, dev)
    steps = eng.steps_per_dispatch

    def run_prefill():
        dec.prefill(eng.params, eng.cache, toks, lengths, slots, cfg)

    def run_decode():
        dec.decode_state_loop(eng.params, eng.cache, eng._state, steps, cfg)

    with torch.inference_mode():
        for name, fn, per in (("prefill_8x2048", run_prefill, 1),
                              ("decode_dispatch", run_decode, steps)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            log("time " + json.dumps({
                "phase": name, "wall_ms": wall_ms,
                "ms_per_step": wall_ms / per,
                "device_busy_ms_traced": busy,
                "device_busy_share": busy / wall_ms,
                "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                   for e in top}}))


def plain_attention():
    """Attention through the kernels' plain versions, forward (B1's) and
    backward (B2's and B3's), as a differentiable function with ``mha``'s
    signature."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = fa.flash_attention_reference(q, k, v, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return (*fa.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                      ctx.causal), None)

    return lambda q, k, v, causal=True, logit_softcap=0.0: Plain.apply(
        q, k, v, causal)


def train_llama(dev):
    """Phase 6: the training path at full width."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.models import config as mcfg
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import (init_sharded_state, make_optimizer,
                                        make_train_step)
    from ray_tpu_torch.parallel.train_step import _leaves

    cfg = mcfg.llama_1b()
    layers = cfg.num_layers
    opt = make_optimizer(warmup_steps=2, total_steps=100)
    t0 = time.perf_counter()
    state, sh = init_sharded_state(cfg, None, opt, seed=0)
    step = make_train_step(cfg, None, opt, sh)   # bf16 compute, remat=True
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(state.params))
    log(f"train state up (llama_1b, {n_params / 1e9:.3f} B params, fp32 "
        f"params and Adam state): {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (TRAIN_BATCH, TRAIN_SEQ + 1))
             .astype(np.int32)}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    counters = (fa.flash_attention, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"].item())
        log(f"train step {i}: loss {losses[-1]:.6f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, {step_ms[-1]:.1f} ms")
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()

    timed = sorted(step_ms[TRAIN_UNTIMED:])
    med = timed[len(timed) // 2] if len(timed) % 2 else (
        timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    flops = cfg.flops_per_token(TRAIN_SEQ) * tokens
    stats = {"steps": TRAIN_STEPS, "untimed": TRAIN_UNTIMED,
             "losses": losses, "step_ms": step_ms, "step_ms_median": med,
             "tokens_per_s": tokens / (med / 1e3),
             "model_flops_per_step": flops,
             "share_of_bf16_peak": flops / (med / 1e3) / PEAK_BF16_FLOPS,
             "peak_mem_gb": peak / 1e9,
             "launches_per_step": {
                 "flash_attention_fwd": launches[0] / TRAIN_STEPS,
                 "flash_attention_bwd_dq": launches[1] / TRAIN_STEPS,
                 "flash_attention_bwd_dkv": launches[2] / TRAIN_STEPS}}
    log("train " + json.dumps(stats))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    want = [2 * layers * TRAIN_STEPS, layers * TRAIN_STEPS,
            layers * TRAIN_STEPS]
    if launches != want:
        raise AssertionError(f"kernel launches B1/B2/B3 over {TRAIN_STEPS} "
                             f"steps: {launches}, want {want} (2L/L/L per "
                             f"step, L = {layers})")

    compare_train_step(state, batch, cfg, dev)
    time_lm_head_loss(state, cfg, dev)

    # one step traced: device-busy share and the kernels that take the most
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, metrics = step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    by_category = {}
    for e in kernels:
        cat = kernel_category(e.key)
        by_category[cat] = (by_category.get(cat, 0.0)
                            + e.self_device_time_total / 1e3)
    log("time " + json.dumps({
        "phase": "train_step", "wall_ms": wall_ms,
        "device_busy_ms_traced": busy, "device_busy_share": busy / wall_ms,
        "by_category_ms": dict(sorted(by_category.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                           for e in top}}))
    return stats, launches


def kernel_category(name: str) -> str:
    """A device kernel's name -> what it does, for the time breakdown."""
    for cat, keys in (
            ("flash_fwd (B1)", ("flash_fwd_kernel",)),
            ("flash_bwd_dq (B2)", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv (B3)", ("flash_bwd_dkv_kernel",)),
            ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
            ("optimizer (foreach)", ("foreach", "multi_tensor")),
            ("reductions", ("reduce",)),
            ("copies and casts", ("copy",)),
            ("elementwise", ("elementwise",))):
        if any(k in name for k in keys):
            return cat
    return "other"


def compare_train_step(state, batch, cfg, dev):
    """One step's loss and gradients with attention through the kernels,
    against the same step with attention through their plain versions."""
    import torch
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel.train_step import _leaves

    batch_t = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
    leaves = _leaves(state.params)

    def loss_and_grads():
        total, metrics = transformer.causal_lm_loss(state.params, batch_t,
                                                    cfg, remat=True)
        return metrics["loss"].item(), torch.autograd.grad(total, leaves)

    kern_loss, kern = loss_and_grads()
    with patched(transformer, "mha", plain_attention()):
        plain_loss, plain = loss_and_grads()
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(kern, plain)]
    row = {"loss_kernels": kern_loss, "loss_plain_versions": plain_loss,
           "abs_loss_diff": abs(kern_loss - plain_loss),
           "max_leaf_rel_l2": max(rel),
           "median_leaf_rel_l2": sorted(rel)[len(rel) // 2],
           "leaves": len(rel)}
    log("train_step_vs_plain " + json.dumps(row))
    if not (row["abs_loss_diff"] <= STEP_LOSS_ATOL
            and row["max_leaf_rel_l2"] <= STEP_GRAD_REL_L2):
        raise AssertionError(
            f"training step through the kernels differs from the plain "
            f"versions' by |dloss| {row['abs_loss_diff']} (limit "
            f"{STEP_LOSS_ATOL}), leaf rel L2 {row['max_leaf_rel_l2']} "
            f"(limit {STEP_GRAD_REL_L2})")
    del kern, plain


def time_lm_head_loss(state, cfg, dev):
    """The loss layer alone: ``chunked_cross_entropy`` (LM head + cross
    entropy, chunks of 512) forward and backward at the training shape,
    beside its four head products' bound at the bf16 peak."""
    import torch
    from ray_tpu_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.hidden_size), generator=gen,
                    device=dev, dtype=torch.bfloat16).requires_grad_()
    w = transformer.lm_head_weight(state.params, cfg, torch.bfloat16)
    w = w.detach().requires_grad_()
    targets = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                            generator=gen, device=dev)

    def fwd_bwd():
        nll = transformer.chunked_cross_entropy(x, w, targets, 512)
        torch.autograd.grad(nll.mean(), (x, w))

    flops = 4 * 2 * TRAIN_BATCH * TRAIN_SEQ * cfg.hidden_size * cfg.vocab_size
    row = {"ms": time_ms(fwd_bwd, 3, 1),
           "head_products_bound_ms": flops / PEAK_BF16_FLOPS * 1e3}
    log("lm_head_loss " + json.dumps(row))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not (ROOT / "ray_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the ray_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for float32 matmuls and cuDNN convolutions")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    from ray_tpu_torch.ops import _build
    with phase("build"):
        built = _build.build()
        log(f"build: {json.dumps(built)}")
        for name, text in _build.build_logs.items():
            for line in text.splitlines():
                if ("registers" in line or "spill" in line or "error" in line
                        or "entry function" in line):
                    log(f"  nvcc[{name}] {line.strip()}")

    with phase("flash_forward_kernel"):
        flash_rows = check_flash(dev)
    with phase("flash_backward_kernels"):
        bwd_rows = check_flash_bwd(dev)
    with phase("serve_llama3_8b"):
        _, serve_launches = serve_llama(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_llama_1b"):
        _, train_launches = train_llama(dev)

    main_row, bwd_row = flash_rows[0], bwd_rows[0]
    sdpa_covers = "dq, dk and dv in one call: B2 + B3 together"
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:42",
        "launches": serve_launches + train_launches[0],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches[0]},
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:201",
        "launches": train_launches[1],
        "max_abs_err": max(r["dq_max_abs_err"] for r in bwd_rows),
        "ms": bwd_row["dq_ms"],
        "plain_ms": bwd_row["dq_plain_ms"],
        "bound_ms": bwd_row["dq_bound_ms"],
        "bound_by": bwd_row["dq_bound_by"],
        "library_ms": bwd_row["sdpa_bwd_ms"],
        "library_covers": sdpa_covers,
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:248",
        "launches": train_launches[2],
        "max_abs_err": max(max(r["dk_max_abs_err"], r["dv_max_abs_err"])
                           for r in bwd_rows),
        "ms": bwd_row["dkv_ms"],
        "plain_ms": bwd_row["dkv_plain_ms"],
        "bound_ms": bwd_row["dkv_bound_ms"],
        "bound_by": bwd_row["dkv_bound_by"],
        "library_ms": bwd_row["sdpa_bwd_ms"],
        "library_covers": sdpa_covers,
    }]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
