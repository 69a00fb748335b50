"""On-demand profiler capture (``raytpu profile --node <id>``).

Two capture modes behind one ``capture()`` entry point:

* **torch.profiler** when the process has already initialised CUDA (a
  GPU train/serve worker): the CPU and CUDA activities of the window as
  one chrome-trace JSON file (kernels included), which is strictly
  richer than anything a Python sampler can see.
* **Thread-stack sampling** otherwise: a sibling thread samples
  ``sys._current_frames()`` at ``period_s`` and emits Chrome Trace
  Event Format (``B``/``E`` frame pairs per thread — a flame chart in
  chrome://tracing or Perfetto).  This is the CPU/CI fallback and the
  mode used to profile the node agent itself; it needs no dependencies
  and never touches the accelerator runtime.

The RPC plumbing (node_agent ``handle_profile`` -> worker
``handle_profile``) runs the sampler OFF the event loop (it sleeps for
the whole capture window).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Tuple


def _cuda_ready() -> bool:
    """True only when torch is ALREADY imported here and has initialised
    CUDA — the profiler must never be the thing that initializes an
    accelerator runtime."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:
        return False


def _stack_of(frame) -> List[Tuple[tuple, str]]:
    """Outermost-first [(identity, label)] for one thread's live frame.
    Identity excludes the line number: a loop advancing its own lineno
    must not churn the open/close events every sample."""
    out = []
    f = frame
    while f is not None:
        code = f.f_code
        ident = (code.co_filename, code.co_name)
        label = (f"{code.co_name} "
                 f"({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
        out.append((ident, label))
        f = f.f_back
    out.reverse()
    return out


def sample_stacks(duration_s: float, period_s: float = 0.01) -> List[dict]:
    """Sample every OTHER thread's stack for ``duration_s`` and coalesce
    consecutive identical frames into Chrome ``B``/``E`` slice pairs —
    the output loads as a flame chart per thread."""
    me = threading.get_ident()
    pid = os.getpid()
    events: List[dict] = []
    open_stacks: Dict[int, List[Tuple[tuple, str]]] = {}
    named: set = set()
    t_end = time.monotonic() + max(duration_s, period_s)
    while time.monotonic() < t_end:
        now_us = time.time() * 1e6
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        seen = set()
        for tid, frame in frames.items():
            if tid == me:
                continue
            seen.add(tid)
            if tid not in named:
                named.add(tid)
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": names.get(tid, str(tid))}})
            stack = _stack_of(frame)
            prev = open_stacks.get(tid, [])
            i = 0
            while (i < len(prev) and i < len(stack)
                   and prev[i][0] == stack[i][0]):
                i += 1
            for j in range(len(prev) - 1, i - 1, -1):
                events.append({"ph": "E", "pid": pid, "tid": tid,
                               "ts": now_us, "name": prev[j][1],
                               "cat": "stack"})
            for j in range(i, len(stack)):
                events.append({"ph": "B", "pid": pid, "tid": tid,
                               "ts": now_us, "name": stack[j][1],
                               "cat": "stack"})
            open_stacks[tid] = stack
        # threads that exited since the last tick: close their slices
        for tid in [t for t in open_stacks if t not in seen]:
            now_us = time.time() * 1e6
            for _ident, label in reversed(open_stacks.pop(tid)):
                events.append({"ph": "E", "pid": pid, "tid": tid,
                               "ts": now_us, "name": label,
                               "cat": "stack"})
        time.sleep(period_s)
    end_us = time.time() * 1e6
    for tid, stack in open_stacks.items():
        for _ident, label in reversed(stack):
            events.append({"ph": "E", "pid": pid, "tid": tid,
                           "ts": end_us, "name": label, "cat": "stack"})
    return events


def capture(duration_s: float, out_dir: str,
            prefer_torch: bool = True) -> Tuple[str, str]:
    """Capture ``duration_s`` of this process; returns (artifact_path,
    mode).  Mode "torch": ``artifact_path`` is the ``torch.profiler``
    chrome-trace JSON file; mode "stacks": a chrome-trace JSON file of
    sampled stacks."""
    os.makedirs(out_dir, exist_ok=True)
    stamp = f"{os.getpid()}-{int(time.time())}"
    if prefer_torch and _cuda_ready():
        import torch
        from torch.profiler import ProfilerActivity, profile
        path = os.path.join(out_dir, f"torch-trace-{stamp}.trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(duration_s)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        return path, "torch"
    events = sample_stacks(duration_s)
    path = os.path.join(out_dir, f"stacks-{stamp}.trace.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, path)
    return path, "stacks"
