"""Time ray_tpu_torch's one-shard (tp=1) decode dispatch of full-width
Llama-3-8B on one CUDA card, for two or more copies of the package.

    python3 decode_dispatch_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a directory that holds a ``ray_tpu_torch`` package.  All of
them load into one process, each under a name of its own (the package
imports itself only relatively), and share one set of weights and caches.
A dispatch is ``decode_state_loop`` (dense cache) or
``paged_decode_state_loop`` (paged cache, 64-token pages): 8 decode steps
of 8 active slots plus the engine's scratch slot, from cache length 1024,
on random bf16 weights drawn from seed 0 as chip_smoke.py's serving phases
draw them.  The trees take turns, one dispatch each per round, in forward
order on even rounds and backward on odd ones, so the host's load, which
moves a dispatch's time by a third within a minute on a shared machine,
falls on every tree alike.  Per dispatch: ``ms_per_step``, from the call
to a synchronize after it, and ``host_cpu_ms_per_step``, the CPU time of
the thread that enqueues the work (not counting time the thread waited for
a core).  Decode at this size is host-bound, so the host's CPU time is what
a change to the Python layer loop moves.  One more dispatch of each tree
counts the work the host does: the aten ops it dispatches (each one a
kernel launch or a view) and the Python and C function calls it makes,
per decode step.  Prints the card's name and power limit, then one JSON
line per ROOT with medians and counts and, for every ROOT after the first,
the median and quartiles of its paired ratio to the first; ``--out``
writes those rows and every sample to FILE as JSON.
"""

from __future__ import annotations

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
WARM, ROUNDS = 2, 60


def load(root: Path, name: str):
    """``root``'s ray_tpu_torch package, imported as ``name``."""
    init = root / "ray_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return {m: importlib.import_module(f"{name}.models.{m}")
            for m in ("config", "transformer", "decode", "paged_decode")}


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_dispatch_ab: no CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    out = None
    if "--out" in args:
        at = args.index("--out")
        out = Path(args[at + 1])
        del args[at:at + 2]
    roots = [Path(r).resolve() for r in args]
    if len(roots) < 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    trees = [load(r, f"ray_tpu_torch_ab{i}") for i, r in enumerate(roots)]

    dev = torch.device("cuda", 0)
    mods = trees[0]
    cfg = mods["config"].llama3_8b()
    params = mods["transformer"].init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, dtype=torch.bfloat16)
    n, pages = SLOTS + 1, MAX_LEN // PAGE
    caches = {
        "dense": mods["decode"].init_kv_cache(cfg, n, MAX_LEN,
                                              torch.bfloat16, dev),
        "paged": mods["paged_decode"].init_paged_cache(
            cfg, SLOTS * pages + 1, PAGE, n, pages, torch.bfloat16, dev)}
    caches["paged"]["block_table"][:SLOTS] = 1 + torch.arange(
        SLOTS * pages, device=dev, dtype=torch.int32).reshape(SLOTS, pages)

    def dispatch(tree, mode, count=False):
        cache = caches[mode]
        cache["length"].zero_()[:SLOTS] = START_LEN
        st = tree["decode"].init_decode_state(
            n, torch.Generator(device=dev).manual_seed(1))
        st["tokens"][:SLOTS] = torch.arange(1, SLOTS + 1, device=dev)
        st["active"][:SLOTS] = True
        st["budget"][:SLOTS] = 1 << 30
        loop = (tree["decode"].decode_state_loop if mode == "dense"
                else tree["paged_decode"].paged_decode_state_loop)
        torch.cuda.synchronize()
        if count:
            return count_host_work(lambda: loop(params, cache, st, STEPS, cfg))
        c0, t0 = time.thread_time(), time.perf_counter()
        loop(params, cache, st, STEPS, cfg)
        c1 = time.thread_time()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t2 - t0) * 1e3 / STEPS, (c1 - c0) * 1e3 / STEPS

    keys = ("ms_per_step", "host_cpu_ms_per_step")
    samples = [{m: {k: [] for k in keys} for m in caches} for _ in trees]
    with torch.inference_mode():
        for mode in caches:
            for r in range(WARM + ROUNDS):
                order = range(len(trees))
                for i in (order if r % 2 == 0 else reversed(order)):
                    got = dispatch(trees[i], mode)
                    if r >= WARM:
                        for k, v in zip(keys, got):
                            samples[i][mode][k].append(v)
        counts = [{m: dispatch(t, m, count=True) for m in caches}
                  for t in trees]
    rows = []
    for root, s, cnt in zip(roots, samples, counts):
        row = {"root": str(root)}
        for mode, per in s.items():
            row[mode] = {k: statistics.median(v) for k, v in per.items()}
            row[mode]["ms_per_step_min_max"] = [min(per["ms_per_step"]),
                                                max(per["ms_per_step"])]
            row[mode].update(cnt[mode])
            if s is not samples[0]:
                for k in keys:
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
