"""ray_tpu_torch.native — C++ runtime components.

The compute path is PyTorch and the CUDA kernels of ``csrc/``; the runtime
around it goes native where the reference's does (SURVEY §2.1: the
store/allocator layer is C++ plasma).  Components build on first use with
g++ (pybind11 is not used, so the ABI is plain C consumed via ctypes) into
the git-ignored ``ray_tpu_torch/_build/native/``, never next to the source.

``shm_pool``: single-mmap arena allocator backing the object store — the
plasma design (one mapping per node, objects are offsets) instead of the
round-1 file-per-object layout (which paid open+ftruncate+mmap+page-zero on
every put).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "shm_pool.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build", "native")


def _build_lib(src: str = _SRC, name: str = "libshmpool.so"
               ) -> Optional[str]:
    """Compile a .so into ``_BUILD_DIR`` (cached by mtime)."""
    out = os.path.join(_BUILD_DIR, name)
    try:
        if (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src)):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def load_shm_pool() -> Optional[ctypes.CDLL]:
    """The compiled allocator, or None (callers fall back to pure Python)."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = _build_lib()
        if path is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _LIB_FAILED = True
            return None
        lib.rt_pool_create.restype = ctypes.c_void_p
        lib.rt_pool_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rt_pool_alloc.restype = ctypes.c_int64
        lib.rt_pool_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rt_pool_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rt_pool_used.restype = ctypes.c_uint64
        lib.rt_pool_used.argtypes = [ctypes.c_void_p]
        lib.rt_pool_capacity.restype = ctypes.c_uint64
        lib.rt_pool_capacity.argtypes = [ctypes.c_void_p]
        lib.rt_pool_num_blocks.restype = ctypes.c_uint64
        lib.rt_pool_num_blocks.argtypes = [ctypes.c_void_p]
        lib.rt_pool_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int]
        # Introspection (older cached .so builds may predate these)
        for sym, res, args in (
                ("rt_pool_block_size", ctypes.c_uint64,
                 [ctypes.c_void_p, ctypes.c_uint64]),
                ("rt_pool_largest_free", ctypes.c_uint64,
                 [ctypes.c_void_p]),
                ("rt_pool_free_blocks", ctypes.c_uint64,
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                  ctypes.c_uint64])):
            fn = getattr(lib, sym, None)
            if fn is not None:
                fn.restype = res
                fn.argtypes = args
        _LIB = lib
        return _LIB


_SP_LIB: Optional[ctypes.CDLL] = None
_SP_FAILED = False


def load_submit_plane() -> Optional[ctypes.CDLL]:
    """The packed spec-frame packer/scanner (``sp_pack``/``sp_scan``), or
    None — callers use the byte-identical pure-Python struct path.  A
    missing compiler, a wedged cached .so, or a stale build lacking the
    symbols degrades to the fallback with ONE warning; importing this
    module never fails on native-build problems."""
    global _SP_LIB, _SP_FAILED
    if _SP_LIB is not None or _SP_FAILED:
        return _SP_LIB
    with _BUILD_LOCK:
        if _SP_LIB is not None or _SP_FAILED:
            return _SP_LIB
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "submit_plane.cpp")
        path = _build_lib(src, "libsubmitplane.so")
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                lib.sp_pack.restype = ctypes.c_int64
                lib.sp_pack.argtypes = [
                    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
                    ctypes.c_char_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_uint32)]
                lib.sp_scan.restype = ctypes.c_int32
                lib.sp_scan.argtypes = [
                    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_uint32)]
            except (OSError, AttributeError):
                lib = None
        if lib is None:
            _SP_FAILED = True
            import warnings
            warnings.warn(
                "native submit-plane encoder unavailable (build or load "
                "failed); using the pure-Python packed-frame fallback",
                RuntimeWarning, stacklevel=2)
            return None
        _SP_LIB = lib
        return _SP_LIB


def submit_plane_loaded() -> bool:
    """Whether the native packer is currently live — pure introspection,
    never triggers a build (False before first use AND after a failed
    build; the counters plane reports actual state, not intent)."""
    return _SP_LIB is not None


_CRC_LIB: Optional[ctypes.CDLL] = None
_CRC_FAILED = False


def load_crc32c():
    """Native CRC-32C ``fn(data: bytes) -> int``, or None (callers fall
    back to the pure-Python table loop). SSE4.2 hardware CRC when the
    CPU has it — the TFRecord/TensorBoard write paths checksum every
    payload, where ~10 MB/s pure Python is the bottleneck."""
    global _CRC_LIB, _CRC_FAILED
    if _CRC_LIB is not None or _CRC_FAILED:
        return _crc_fn if _CRC_LIB is not None else None
    with _BUILD_LOCK:
        if _CRC_LIB is not None or _CRC_FAILED:
            return _crc_fn if _CRC_LIB is not None else None
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "crc32c.cpp")
        path = _build_lib(src, "libcrc32c.so")
        if path is None:
            _CRC_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.rt_crc32c.restype = ctypes.c_uint32
            lib.rt_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_uint32]
        except (OSError, AttributeError):
            _CRC_FAILED = True
            return None
        _CRC_LIB = lib
        return _crc_fn


def _crc_fn(data, seed: int = 0) -> int:
    if isinstance(data, bytes):
        return _CRC_LIB.rt_crc32c(data, len(data), seed)
    # Buffer-protocol payloads (the transfer plane checksums chunks that
    # landed directly in a shm segment view): hand ctypes the buffer
    # in place — round-tripping through bytes() would copy the chunk.
    mv = memoryview(data)
    if mv.readonly:
        arr = (ctypes.c_char * mv.nbytes).from_buffer_copy(mv)
    else:
        arr = (ctypes.c_char * mv.nbytes).from_buffer(mv)
    return _CRC_LIB.rt_crc32c(arr, mv.nbytes, seed)


class ShmPool:
    """Owner-side arena: allocate/free offsets in one shm mapping."""

    def __init__(self, path: str, capacity: int):
        lib = load_shm_pool()
        if lib is None:
            raise RuntimeError("native shm pool unavailable (no g++?)")
        self._lib = lib
        self.path = path
        self._handle = lib.rt_pool_create(path.encode(), capacity)
        if not self._handle:
            raise OSError(f"failed to create shm pool at {path}")
        import mmap as _mmap
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = _mmap.mmap(fd, capacity)
        finally:
            os.close(fd)

    def alloc(self, size: int) -> int:
        """-> offset, or -1 when the arena is full (caller evicts)."""
        return self._lib.rt_pool_alloc(self._handle, size)

    def free(self, offset: int):
        self._lib.rt_pool_free(self._handle, offset)

    def view(self, offset: int, size: int) -> memoryview:
        return memoryview(self._mm)[offset:offset + size]

    @property
    def used(self) -> int:
        return self._lib.rt_pool_used(self._handle)

    @property
    def capacity(self) -> int:
        return self._lib.rt_pool_capacity(self._handle)

    @property
    def num_blocks(self) -> int:
        return self._lib.rt_pool_num_blocks(self._handle)

    def block_size(self, offset: int) -> int:
        """Size of the live allocation at ``offset`` (0 = not allocated)."""
        fn = getattr(self._lib, "rt_pool_block_size", None)
        return int(fn(self._handle, offset)) if fn is not None else 0

    @property
    def largest_free(self) -> int:
        """Largest free block — the arena's fragmentation signal."""
        fn = getattr(self._lib, "rt_pool_largest_free", None)
        return int(fn(self._handle)) if fn is not None else 0

    def free_blocks(self, max_n: int = 4096) -> list:
        """Sizes of up to ``max_n`` free blocks (the fragmentation
        histogram's raw data); [] when the cached .so predates the
        introspection symbol."""
        fn = getattr(self._lib, "rt_pool_free_blocks", None)
        if fn is None or not self._handle:
            return []
        buf = (ctypes.c_uint64 * max_n)()
        n = int(fn(self._handle, buf, max_n))
        return [int(buf[i]) for i in range(min(n, max_n))]

    def close(self, unlink: bool = True):
        if self._handle:
            try:
                self._mm.close()
            except Exception:
                pass
            self._lib.rt_pool_destroy(self._handle, 1 if unlink else 0)
            self._handle = None
