"""Usage-stats collection (reference: ``python/ray/_private/usage/usage_lib.py``).

The reference gathers cluster metadata, library usages, and extra tags,
writes ``usage_stats.json`` locally, and (when enabled) reports to a
collection server.  Redesigned for the offline-first TPU deployment:
there is NO phone-home — the report is written to the session directory
at shutdown and exposed over the dashboard (``/api/usage_stats``) so
operators see the same rollup the reference would have uploaded.
Collection is enabled by default and disabled with
``RAYTPU_USAGE_STATS_ENABLED=0`` (reference: ``usage_stats_enabledness``,
env var + config file; ours is env-only — there is no interactive prompt
to honor on a cluster node).

What is collected (schema mirrors ``UsageStatsToReport``):
- cluster metadata: framework version, python/torch versions, platform
- cluster status: node count, total resources, running jobs
- library usages: which AI libraries were imported (data/train/tune/…)
- extra usage tags: free-form ``record_extra_usage_tag`` key/values

Recording NEVER does I/O at the call site (library ``__init__`` hooks run
under the import lock): records persist in-process and flush to the GCS
KV from (a) ``ray_tpu_torch.init`` on the driver, (b) every CoreWorker's
periodic flush loop — which is how WORKER-side library imports reach the
cluster report — and (c) report assembly.  The buffer is never consumed,
so a re-``init`` against a fresh cluster re-reports everything (the
reference keeps the same process-lifetime set).

Usage::

    from ray_tpu_torch.util import usage_stats
    usage_stats.record_library_usage("data")
    usage_stats.record_extra_usage_tag("serve_num_deployments", "3")
    report = usage_stats.generate_report()   # dict; also see CLI/REST
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

#: private KV namespace — the user-facing default ("kv") must stay free of
#: telemetry keys (internal_kv's isolation invariant)
_NS = "usage_stats"
SCHEMA_VERSION = "0.1"

# Process-lifetime records (never consumed; see module docstring).
_usages: List[str] = []
_tags: Dict[str, str] = {}
#: (gcs_address, snapshot) of the last successful flush — flushing is a
#: no-op while nothing changed and the cluster is the same one
_flushed: Optional[Tuple[str, tuple]] = None


def usage_stats_enabled() -> bool:
    raw = os.environ.get("RAYTPU_USAGE_STATS_ENABLED", "1")
    return raw.strip().lower() not in ("0", "false", "no", "off")


def record_library_usage(library: str):
    """Mark an AI library as used this process lifetime (idempotent).
    Reference: ``usage_lib.record_library_usage`` — called from each
    library's ``__init__``.  Records only; no I/O under the import lock."""
    if not usage_stats_enabled():
        return
    if library not in _usages:
        _usages.append(library)


def record_extra_usage_tag(key: str, value: str):
    """Attach a free-form tag to the report (last write wins).
    Reference: ``usage_lib.record_extra_usage_tag`` (TagKey enum relaxed
    to plain strings — the closed enum exists for the upload pipeline we
    deliberately don't have)."""
    if not usage_stats_enabled():
        return
    _tags[key] = str(value)


def _snapshot() -> tuple:
    return (tuple(_usages), tuple(sorted(_tags.items())))


async def flush_via(call, gcs_address: str):
    """Async flush through a caller-supplied GCS ``call`` — usable from
    any process's IO loop (driver or worker; reference: worker-side usage
    records reach the GCS the same way).  Cheap no-op while nothing
    changed since the last successful flush to THIS cluster."""
    global _flushed
    if not usage_stats_enabled():
        return
    snap = _snapshot()
    if _flushed == (gcs_address, snap):
        return
    for lib in snap[0]:
        await call("kv_put", ns=_NS, key=f"lib:{lib}", value=b"1",
                   overwrite=True)
    for k, v in snap[1]:
        await call("kv_put", ns=_NS, key=f"tag:{k}", value=v.encode(),
                   overwrite=True)
    _flushed = (gcs_address, snap)


def flush(_raise: bool = False, timeout_s: float = 10.0):
    """Sync flush from the driver (called by ``ray_tpu_torch.init`` and before
    report assembly; reference: ``put_pre_init_usage_stats``).  Safe no-op
    when disabled or no worker is attached."""
    from ray_tpu_torch.core.core_worker import global_worker_or_none
    from ray_tpu_torch.core.rpc import run_async
    w = global_worker_or_none()
    if w is None:
        return
    try:
        run_async(flush_via(w.gcs.call, w.gcs_address), timeout=timeout_s)
    except Exception:
        if _raise:
            raise  # tests; production callers never want telemetry to break init


def forget_flushed_state():
    """Called from ``ray_tpu_torch.shutdown``: the next cluster must receive the
    records again even if it reuses this one's GCS address (a restarted
    head has an empty KV)."""
    global _flushed
    _flushed = None


def _cluster_metadata() -> Dict[str, Any]:
    """Reference: ``_generate_cluster_metadata`` — static facts that
    identify the deployment shape, never the workload's data."""
    import ray_tpu_torch
    meta = {
        "schema_version": SCHEMA_VERSION,
        "source": "ray_tpu_torch",
        "ray_tpu_version": getattr(ray_tpu_torch, "__version__", "dev"),
        "python_version": sys.version.split()[0],
        "os": platform.system().lower(),
        "collected_at": int(time.time()),
    }
    try:
        # version via package metadata, NOT `import torch` — a report must
        # not pay (or trigger) a multi-second import
        from importlib.metadata import version
        meta["torch_version"] = version("torch")
    except Exception:
        meta["torch_version"] = None
    return meta


def generate_report(timeout_s: float = 5.0) -> Dict[str, Any]:
    """Assemble the full report from the cluster KV + live GCS state
    (reference: ``generate_report_data``).  Works in any process with an
    attached CoreWorker (driver, worker, or a dashboard actor)."""
    from ray_tpu_torch.core.core_worker import global_worker
    from ray_tpu_torch.core.rpc import run_async

    w = global_worker()
    flush(timeout_s=timeout_s)
    libs: List[str] = []
    tags: Dict[str, str] = {}
    for key in run_async(w.gcs.call("kv_keys", ns=_NS, prefix=""),
                         timeout=timeout_s):
        if key.startswith("lib:"):
            libs.append(key[4:])
        elif key.startswith("tag:"):
            raw = run_async(w.gcs.call("kv_get", ns=_NS, key=key),
                            timeout=timeout_s)
            tags[key[4:]] = raw.decode() if raw else ""

    status: Dict[str, Any] = {"total_num_nodes": None,
                              "total_resources": None,
                              "total_num_running_jobs": None}
    try:
        view = run_async(w.gcs.call("get_cluster_view"), timeout=timeout_s)
        alive = [v for v in view.values() if v.get("alive", True)]
        status["total_num_nodes"] = len(alive)
        total: Dict[str, float] = {}
        for v in alive:
            for r, n in (v.get("total") or {}).items():
                total[r] = total.get(r, 0.0) + n
        status["total_resources"] = total
        jobs = run_async(w.gcs.call("list_jobs"), timeout=timeout_s)
        status["total_num_running_jobs"] = sum(
            1 for j in jobs.values()
            if j.get("status") in ("RUNNING", "PENDING")) if isinstance(
                jobs, dict) else None
    except Exception:
        pass

    return {**_cluster_metadata(),
            "cluster_status": status,
            "library_usages": sorted(libs),
            "extra_usage_tags": tags}


def write_report(session_dir: Optional[str] = None,
                 timeout_s: float = 5.0) -> Optional[str]:
    """Dump ``usage_stats.json`` into the session directory (reference:
    ``UsageStatsToWrite`` written next to the session logs).  Called from
    ``ray_tpu_torch.shutdown`` with a SHORT timeout — a dead GCS at exit must
    not stall the interpreter.  Returns the path, or None when
    disabled/unattached."""
    from ray_tpu_torch.core.core_worker import global_worker_or_none
    if not usage_stats_enabled() or global_worker_or_none() is None:
        return None
    from ray_tpu_torch.core.api import _state
    d = session_dir or _state.session_dir
    if not d:
        return None
    path = os.path.join(d, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(generate_report(timeout_s=timeout_s), f,
                      indent=1, sort_keys=True)
        return path
    except Exception:
        return None


def reset_global_state():
    """Test hook (reference: ``usage_lib.reset_global_state``)."""
    global _flushed
    _usages.clear()
    _tags.clear()
    _flushed = None
