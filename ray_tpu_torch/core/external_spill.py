"""External (fsspec-backed) object spill tier.

The durability leg of the object plane (reference: the raylet's
``object_spilling_config`` with smart_open/fsspec URIs): spilled objects
are written ONCE to a cluster-readable URI (``gs://bucket/prefix`` in
production, ``file:///dir`` in tests) and registered with the owner as a
*location that is not a node* — the sentinel node id
:data:`EXTERNAL_NODE_ID` paired with the object's URI rides the normal
``add_object_location`` path, flows through the owner's location list, and
is accepted by **any** node's pull path as a valid chunk source
(``NodeAgent._fetch_chunk`` range-reads the URI instead of issuing a
``read_chunk`` RPC).  Losing the node that spilled the object therefore no
longer loses the object.

Layout is deterministic — ``{base_uri}/{object_id.hex()}.obj`` — so every
process derives the same URI from the same id; no directory listing on the
read path.  All IO goes through fsspec; for ``file://`` URIs a plain-os
fallback keeps the tier working even where fsspec is absent.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

#: sentinel ``node_id`` for owner location entries that point at an
#: external URI rather than a node agent (address field = the URI)
EXTERNAL_NODE_ID = "external"

_OBJ_SUFFIX = ".obj"


def is_external_address(addr: str) -> bool:
    """True for location ADDRESSES that are external-tier URIs, not
    ``host:port`` agent endpoints (every fsspec URI carries a scheme)."""
    return "://" in (addr or "")


def object_uri(base_uri: str, object_id) -> str:
    """Deterministic per-object URI under the external tier base."""
    hexid = object_id.hex() if hasattr(object_id, "hex") else str(object_id)
    return f"{base_uri.rstrip('/')}/{hexid}{_OBJ_SUFFIX}"


# ------------------------------------------------------------- self-metrics

def _build_spill_metrics():
    from ray_tpu_torch.util.metrics import Counter, Histogram
    return {
        "bytes": Counter(
            "raytpu_spill_bytes_total",
            "object bytes spilled out of the shm store, by tier",
            tag_keys=("tier",)),
        "restore_seconds": Histogram(
            "raytpu_spill_restore_seconds",
            "spilled-object restore latency (read -> resident in store)",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                        2.5, 5.0, 15.0, 60.0]),
    }


_spill_metrics_get = None

KEY_TIER_LOCAL = (("tier", "local"),)
KEY_TIER_EXTERNAL = (("tier", "external"),)


def spill_metrics():
    global _spill_metrics_get
    if _spill_metrics_get is None:
        # deferred to first call: importing util.metrics at module import
        # time re-enters the ray_tpu_torch package init (circular import)
        from ray_tpu_torch.util.metrics import lazy
        _spill_metrics_get = lazy(_build_spill_metrics)
    return _spill_metrics_get()


# ------------------------------------------------------------------ file IO
#
# fsspec when available (gs://, s3://, any registered scheme); a plain-os
# fallback for file:// so the tier works in minimal environments.  Tests
# monkeypatch these four functions to inject slowness/failures.

def _file_path(uri: str) -> Optional[str]:
    if uri.startswith("file://"):
        return uri[len("file://"):]
    return None


def _fs_and_path(uri: str):
    import fsspec
    return fsspec.core.url_to_fs(uri)


def write(uri: str, data) -> int:
    """Write ``data`` to ``uri`` (parents created); returns bytes written."""
    p = _file_path(uri)
    if p is not None:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)  # readers never observe a partial object
        return len(data)
    fs, path = _fs_and_path(uri)
    fs.makedirs(os.path.dirname(path), exist_ok=True)
    with fs.open(path, "wb") as f:
        f.write(bytes(data))
    return len(data)


def read(uri: str) -> bytes:
    p = _file_path(uri)
    if p is not None:
        with open(p, "rb") as f:
            return f.read()
    fs, path = _fs_and_path(uri)
    with fs.open(path, "rb") as f:
        return f.read()


def read_range(uri: str, offset: int, length: int) -> bytes:
    """Range read — the chunk-source primitive the transfer plane stripes
    over (an external URI participates in a ``StripedPull`` exactly like a
    node source, one chunk at a time)."""
    p = _file_path(uri)
    if p is not None:
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(length)
    fs, path = _fs_and_path(uri)
    with fs.open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def exists(uri: str) -> bool:
    p = _file_path(uri)
    if p is not None:
        return os.path.exists(p)
    try:
        fs, path = _fs_and_path(uri)
        return fs.exists(path)
    except Exception:
        return False


def delete(uri: str) -> bool:
    p = _file_path(uri)
    if p is not None:
        try:
            os.unlink(p)
            return True
        except OSError:
            return False
    try:
        fs, path = _fs_and_path(uri)
        fs.rm(path)
        return True
    except Exception:
        return False


def size(uri: str) -> Optional[int]:
    p = _file_path(uri)
    if p is not None:
        try:
            return os.path.getsize(p)
        except OSError:
            return None
    try:
        fs, path = _fs_and_path(uri)
        return fs.size(path)
    except Exception:
        return None


def list_objects(base_uri: str) -> List[str]:
    """Object URIs currently under the tier base (ops/debug surface)."""
    p = _file_path(base_uri)
    out: List[str] = []
    if p is not None:
        try:
            names = os.listdir(p)
        except OSError:
            return []
        return [f"{base_uri.rstrip('/')}/{n}" for n in sorted(names)
                if n.endswith(_OBJ_SUFFIX)]
    try:
        fs, path = _fs_and_path(base_uri)
        for entry in fs.ls(path, detail=False):
            if str(entry).endswith(_OBJ_SUFFIX):
                out.append(f"{base_uri.split('://', 1)[0]}://{entry}")
    except Exception:
        return []
    return sorted(out)


def timed_read(uri: str) -> bytes:
    """Read + observe ``raytpu_spill_restore_seconds``."""
    t0 = time.monotonic()
    data = read(uri)
    m = spill_metrics()
    if m is not None:
        m["restore_seconds"].observe(time.monotonic() - t0)
    return data
