#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. The card's name and power limit (``nvidia-smi``); TF32 off for float32
   matmuls and convolutions, so the plain versions compute in full f32.
2. Build every CUDA source of the port with nvcc (all at once), timed.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it (Llama-3-8B prefill: B=8, S=2048 and S=1024,
   H=32, KV=8, D=128, causal), plus D=64 non-causal, D=256 and a ragged S.
   Times of the kernel, the plain version and one library call
   (``scaled_dot_product_attention``, a yardstick the port never calls) with
   CUDA events, beside the least time the card could take (bound).
4. The serving path at full width: ``LLMEngine`` on Llama-3-8B (32 layers,
   hidden 4096, random bf16 weights from seed 0), 8 concurrent requests, 5
   with prompts of 1100-1900 tokens (bucket 2048, through the flash kernel)
   and 3 short ones (plain attention), 16 tokens each.  Launch counts are
   zeroed just before and read just after.  Then the prefill logits of one
   batch through the kernel against the same prefill through the kernel's
   plain version, and where the time of one prefill batch and one decode
   dispatch goes (torch.profiler).
5. A JSON line of kernels, then the contract line
   ``{"ok": true, "device": {...}}`` as the last line of output.

Exits non-zero without a result when there is no CUDA card, or when the
``ray_tpu_torch`` package is not beside this script.
"""

from __future__ import annotations

import contextlib
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
# prefill logits through 32 bf16 layers, kernel vs plain version, as a
# share of the logits' std: the rms and the largest of 2 x 128256 differences
LOGITS_RMS = 0.05
LOGITS_MAX = 0.25

LONG_PROMPTS = (1100, 1300, 1500, 1700, 1900)
SHORT_PROMPTS = (40, 50, 60)
MAX_TOKENS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


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


@contextlib.contextmanager
def prefill_attention(fn):
    """Route prefill's attention (``ops.attention.mha``) through ``fn`` for
    one comparison run, then restore it."""
    from ray_tpu_torch.ops import attention
    real = attention.mha
    attention.mha = fn
    try:
        yield
    finally:
        attention.mha = real


def serve_llama(dev):
    """Phase 4: the serving path at full width."""
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
        with prefill_attention(lambda q, k, v, causal=True, logit_softcap=0.0:
                               fa.flash_attention_reference(q, k, v,
                                                            causal)[0]):
            _, ref = dec.prefill(eng.params, cache, toks, lengths, slots, cfg)
        with prefill_attention(lambda q, k, v, causal=True, logit_softcap=0.0:
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
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc[{name}] {line.strip()}")

    flash_rows = check_flash(dev)
    stats, launches = serve_llama(dev)

    main_row = flash_rows[0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:42",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
