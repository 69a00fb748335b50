"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  Libraries
land in ``ray_tpu_torch/_build/`` inside the checkout, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads at once.
Nothing builds at import time: the first launch of a kernel builds it, or a
caller builds every source up front with ``build()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) per source
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """nvcc of the CUDA toolkit PyTorch finds ($CUDA_HOME, $CUDA_PATH, PATH,
    then the usual install location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    exe = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.isfile(exe):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return exe


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, all started together.  Returns seconds per source
    built; raises with nvcc's output when one fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        exe = exe or nvcc()
        # build under a private name, then rename: a concurrent builder of
        # the same source never loads a half-written library
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``bind`` declares the C functions' argtypes/restype once, at load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            bind(lib)
            _libs[name] = lib
        return lib
