"""Time a workload of ray_tpu_torch on one CUDA card for two or more copies
of the package, in one process.

    python3 decode_dispatch_ab.py ROOT [ROOT ...] [--workload decode|train]
                                  [--rounds N] [--out FILE]

Each ROOT is a directory that holds a ``ray_tpu_torch`` package.  All of
them load into one process, each under a name of its own (the package
imports itself only relatively).  The trees take turns, one sample each
per round, in forward order on even rounds and backward on odd ones, so
the host's load, which moves a sample's time by a third within a minute on
a shared machine, falls on every tree alike.  Per sample: ``ms``, from the
call to a synchronize after it, and ``host_cpu_ms``, the CPU time of the
thread that enqueues the work (not counting time the thread waited for a
core).  The workloads:

* ``decode`` (default; 60 rounds): the one-shard (tp=1) decode dispatch of
  full-width Llama-3-8B, ``decode_state_loop`` (dense cache) and
  ``paged_decode_state_loop`` (paged cache, 64-token pages): 8 decode
  steps of 8 active slots plus the engine's scratch slot, from cache
  length 1024, on one set of random bf16 weights drawn from seed 0 as
  chip_smoke.py's serving phases draw them; times per decode step.  Decode
  at this size is host-bound, so the host's CPU time is what a change to
  the Python layer loop moves.  One more dispatch of each tree counts the
  work the host does: the aten ops it dispatches (each one a kernel launch
  or a view) and the Python and C function calls it makes, per decode
  step.
* ``train`` (20 rounds): the one-device (``mesh=None``) train step of
  full-width llama_1b, each tree with its own kernels and its own state
  from seed 0 (fp32 params and Adam state, bf16 compute, full remat, as
  chip_smoke.py's ``train_llama_1b`` phase trains) on one batch of 8 x
  2049 tokens from numpy seed 0, after two warm-up steps whose losses are
  printed (equal trees train alike).

Each mode first runs two untimed rounds.

Prints the card's name and power limit, then one JSON line per ROOT with
medians and, for every ROOT after the first, the quartiles of its paired
ratio to the first; ``--out`` writes those rows and every sample to FILE
as JSON.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOTS = 8                   # active slots; the engine adds a scratch slot
STEPS = 8                   # LLMEngine's steps_per_dispatch
START_LEN = 1024
MAX_LEN = 2048
PAGE = 64
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
WARM = 2
ROUNDS = {"decode": 60, "train": 20}
KEYS = ("ms", "host_cpu_ms")


def load(root: Path, name: str):
    """``root``'s ray_tpu_torch package, imported as ``name``."""
    init = root / "ray_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return lambda module: importlib.import_module(f"{name}.{module}")


def timed(fn, per: int = 1):
    """(ms, host CPU ms) of ``fn()`` up to a synchronize, over ``per``."""
    import torch
    torch.cuda.synchronize()
    c0, t0 = time.thread_time(), time.perf_counter()
    fn()
    c1 = time.thread_time()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t2 - t0) * 1e3 / per, (c1 - c0) * 1e3 / per


def count_host_work(fn) -> dict:
    """Per decode step of ``fn()`` (one dispatch): the aten ops dispatched
    and the Python and C function calls made."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))

    with Ops():
        fn()
    calls = {"call": 0, "c_call": 0}

    def tally(frame, event, arg):
        if event in calls:
            calls[event] += 1
    sys.setprofile(tally)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return {"aten_ops_per_step": Ops.n / STEPS,
            "python_calls_per_step": calls["call"] / STEPS,
            "c_calls_per_step": calls["c_call"] / STEPS}


def decode_workload(trees):
    """-> ({mode: sample(i)}, {mode: count(i)} or None, per-tree extras)."""
    import torch
    dev = torch.device("cuda", 0)
    mod = trees[0]
    cfg = mod("models.config").llama3_8b()
    params = mod("models.transformer").init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dtype=torch.bfloat16)
    n, pages = SLOTS + 1, MAX_LEN // PAGE
    caches = {
        "dense": mod("models.decode").init_kv_cache(cfg, n, MAX_LEN,
                                                    torch.bfloat16, dev),
        "paged": mod("models.paged_decode").init_paged_cache(
            cfg, SLOTS * pages + 1, PAGE, n, pages, torch.bfloat16, dev)}
    caches["paged"]["block_table"][:SLOTS] = 1 + torch.arange(
        SLOTS * pages, device=dev, dtype=torch.int32).reshape(SLOTS, pages)

    def dispatch(i, mode):
        """One dispatch of tree i's loop, from a fresh decode state."""
        tree, cache = trees[i], caches[mode]
        cache["length"].zero_()[:SLOTS] = START_LEN
        st = tree("models.decode").init_decode_state(
            n, torch.Generator(device=dev).manual_seed(1))
        st["tokens"][:SLOTS] = torch.arange(1, SLOTS + 1, device=dev)
        st["active"][:SLOTS] = True
        st["budget"][:SLOTS] = 1 << 30
        loop = (tree("models.decode").decode_state_loop if mode == "dense"
                else tree("models.paged_decode").paged_decode_state_loop)
        return lambda: loop(params, cache, st, STEPS, cfg)

    samples = {m: (lambda i, m=m: timed(dispatch(i, m), STEPS))
               for m in caches}
    counts = {m: (lambda i, m=m: count_host_work(dispatch(i, m)))
              for m in caches}
    return samples, counts, [{} for _ in trees]


def train_workload(trees):
    import numpy as np
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 32768, (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)}
    states, steps, extras = [], [], []
    for mod in trees:
        mod("ops._build").build()
        par = mod("parallel")
        cfg = mod("models.config").llama_1b()
        opt = par.make_optimizer(warmup_steps=2, total_steps=100)
        state, sh = par.init_sharded_state(cfg, None, opt, seed=0)
        step = par.make_train_step(cfg, None, opt, sh, remat=True)
        losses = []
        for _ in range(WARM):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        states.append(state)
        steps.append(step)
        extras.append({"first_losses": losses})

    def sample(i):
        return timed(lambda: steps[i](states[i], batch))
    return {"train": sample}, None, extras


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_dispatch_ab: no CUDA card", file=sys.stderr)
        return 2
    args = iter(sys.argv[1:])
    workload, rounds, out, roots = "decode", None, None, []
    for a in args:
        if a == "--workload":
            workload = next(args)
        elif a == "--rounds":
            rounds = int(next(args))
        elif a == "--out":
            out = Path(next(args))
        else:
            roots.append(Path(a).resolve())
    if len(roots) < 2 or workload not in ROUNDS:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    rounds = ROUNDS[workload] if rounds is None else rounds
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = [load(r, f"ray_tpu_torch_ab{i}") for i, r in enumerate(roots)]
    build = decode_workload if workload == "decode" else train_workload
    sample, count, extras = build(trees)
    samples = [{m: {k: [] for k in KEYS} for m in sample} for _ in trees]
    # decode runs without autograd, as the engine does; the train step
    # takes its own gradients
    with (torch.inference_mode() if workload == "decode"
          else contextlib.nullcontext()):
        for mode, fn in sample.items():
            for r in range(WARM + rounds):
                order = range(len(trees))
                for i in (order if r % 2 == 0 else reversed(order)):
                    got = fn(i)
                    if r >= WARM:
                        for k, v in zip(KEYS, got):
                            samples[i][mode][k].append(v)
        counts = [{m: fn(i) for m, fn in count.items()} if count else {}
                  for i in range(len(trees))]
    rows = []
    for root, s, cnt, extra in zip(roots, samples, counts, extras):
        row = {"root": str(root), "workload": workload, "rounds": rounds,
               **extra}
        for mode, per in s.items():
            row[mode] = {k: statistics.median(v) for k, v in per.items()}
            row[mode]["ms_min_max"] = [min(per["ms"]), max(per["ms"])]
            row[mode].update(cnt.get(mode, {}))
            if s is not samples[0]:
                for k in KEYS:
                    ratios = [a / b for a, b in zip(
                        per[k], samples[0][mode][k])]
                    row[mode][f"{k}_paired_ratio_to_first_quartiles"] = (
                        statistics.quantiles(ratios, n=4))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "rows": rows, "samples": samples}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
