"""@remote functions (reference: ``python/ray/remote_function.py`` — RemoteFunction :40,
``_remote`` :257 builds the TaskSpec options).

Functions ship by content hash through the GCS KV function registry once per process
(reference: ``python/ray/_private/function_manager.py``); the TaskSpec carries only the
hash.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

from . import serialization
from .common import (STREAMING_RETURNS, PlacementGroupSchedulingStrategy,
                     TaskSpec, _TopLevelRef, build_spec_from_template,
                     copy_spec_into)
from .config import get_config
from .ids import TaskID
from .object_ref import ObjectRef
from .rpc import run_async

# Bound on first .remote() call (core_worker imports this module, so a
# top-level import would be circular).
_global_worker = None


def _wrap_args(args, kwargs):
    """Wrap top-level ObjectRefs so the executor resolves them to values
    (nested refs pass through as refs — ray argument semantics)."""
    wargs = [(_TopLevelRef(a) if isinstance(a, ObjectRef) else a) for a in args]
    wkwargs = {k: (_TopLevelRef(v) if isinstance(v, ObjectRef) else v)
               for k, v in kwargs.items()}
    return wargs, wkwargs


def _current_trace_ctx():
    from ray_tpu_torch.util import tracing
    return tracing.current_context()


_EMPTY_ARGS: Optional[bytes] = None


def serialize_args(args, kwargs):
    if not args and not kwargs:
        # No-arg calls (pings, control-plane methods) skip the pickler: the
        # canonical empty blob is byte-identical on every call, so the
        # executor can match it and skip deserialization too.
        global _EMPTY_ARGS
        if _EMPTY_ARGS is None:
            _EMPTY_ARGS = serialization.serialize(([], {})).to_bytes()
        return _EMPTY_ARGS, []
    wargs, wkwargs = _wrap_args(args, kwargs)
    so = serialization.serialize((wargs, wkwargs))
    return so.to_bytes(), list(so.contained_refs)


class RemoteFunction:
    def __init__(self, fn, default_options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._opts = dict(default_options or {})
        self._blob: Optional[bytes] = None
        self._fn_id: Optional[bytes] = None
        self._captured_refs: list = []
        self._registered_in: set = set()
        #: warm-path spec template: every call-invariant field of this
        #: (function, options) pair, built once on the first .remote() and
        #: cloned (pooled slot copy + volatile stores) on every later call.
        #: Keyed to the worker/config generation it was built under —
        #: reinit or set_config() rebuilds.  options() returns a NEW
        #: RemoteFunction, so the template is per-(fn, options) by design.
        self._spec_tmpl: Optional[TaskSpec] = None
        self._spec_tmpl_key: Optional[tuple] = None
        self.__name__ = getattr(fn, "__name__", "anonymous")

    # -- registration ------------------------------------------------------

    def _ensure_registered(self, worker) -> bytes:
        if self._blob is None:
            self._blob, self._captured_refs = \
                serialization.dumps_function_with_refs(self._fn)
            self._fn_id = hashlib.sha1(self._blob).digest()[:16]
        key = id(worker)
        if key not in self._registered_in:
            run_async(worker.gcs.call_retry(
                "kv_put", ns="funcs", key=self._fn_id.hex(),
                value=self._blob, overwrite=False))
            self._registered_in.add(key)
        return self._fn_id

    # -- public API --------------------------------------------------------

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(opts)
        rf = RemoteFunction(self._fn, merged)
        rf._blob, rf._fn_id = self._blob, self._fn_id
        rf._captured_refs = self._captured_refs
        return rf

    def bind(self, *args, **kwargs):
        """Lazy DAG node instead of immediate submission (reference:
        dag/function_node.py)."""
        from ..dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        global _global_worker
        if _global_worker is None:  # deferred: core_worker imports us
            from .core_worker import global_worker as _global_worker
        w = _global_worker()
        cfg = get_config()
        args_blob, arg_refs = serialize_args(args, kwargs)
        # Closure-captured refs are data dependencies exactly like argument
        # refs: they must be pinned until the task finishes, and the batch
        # scheduler must not coalesce this task with their producers.
        if self._captured_refs:
            arg_refs = arg_refs + self._captured_refs
        # Warm path: every call-invariant field comes from the cached
        # template via a pooled slot copy — no per-call resources dict, no
        # option lookups, no TaskSpec ctor.  The key pins the template to
        # this worker AND config generation (registration happened when the
        # template was built for this worker; set_config() swaps the config
        # object, invalidating templates whose fields read old defaults).
        tmpl = self._spec_tmpl
        if (tmpl is not None and cfg.submit_plane_native_enabled
                and self._spec_tmpl_key == (w.worker_id, id(cfg))):
            spec = build_spec_from_template(
                tmpl, TaskID.from_random(), args_blob, _current_trace_ctx())
            num_returns = tmpl.num_returns
        else:
            fn_id = self._ensure_registered(w)
            o = self._opts
            resources = dict(o.get("resources") or ())
            resources["CPU"] = float(o.get("num_cpus", 1))
            if o.get("num_gpus"):
                resources["GPU"] = float(o["num_gpus"])
            if o.get("memory"):
                resources["memory"] = float(o["memory"])
            strategy = o.get("scheduling_strategy", "DEFAULT")
            strategy = resolve_pg_strategy(strategy)
            if o.get("runtime_env"):
                from . import runtime_env as _renv
                _renv.validate(o["runtime_env"])
            num_returns = o.get("num_returns", 1)
            if num_returns in ("streaming", "dynamic"):
                num_returns = STREAMING_RETURNS
            spec = TaskSpec(
                task_id=TaskID.from_random(),
                job_id=w.job_id,
                name=o.get("name") or self.__name__,
                fn_id=fn_id,
                args=args_blob,
                num_returns=num_returns,
                resources=resources,
                owner=w.address,
                scheduling_strategy=strategy,
                max_retries=o.get("max_retries", cfg.default_task_max_retries),
                retry_exceptions=bool(o.get("retry_exceptions", False)),
                runtime_env=o.get("runtime_env"),
                generator_backpressure=int(o.get("generator_backpressure", 0)),
                trace_ctx=_current_trace_ctx(),
            )
            # Cache the template OUTSIDE the free list (never recycled,
            # never submitted — it only ever sources slot copies).  PG
            # strategies stay on the cold path: their bundle placement
            # resolves per call and must not be frozen into a template.
            if (cfg.submit_plane_native_enabled
                    and not isinstance(o.get("scheduling_strategy"),
                                       PlacementGroupSchedulingStrategy)):
                tmpl = TaskSpec.__new__(TaskSpec)
                copy_spec_into(spec, tmpl)
                self._spec_tmpl = tmpl
                self._spec_tmpl_key = (w.worker_id, id(cfg))
        refs = w.submit_task(spec, arg_refs)
        if num_returns == STREAMING_RETURNS:
            return refs  # an ObjectRefGenerator
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Remote function '{self.__name__}' cannot be called directly. "
                        f"Use '{self.__name__}.remote()'.")


def resolve_pg_strategy(strategy):
    """Resolve a PlacementGroupSchedulingStrategy to a bundle-pinned node affinity
    (the PG manager placed bundles on concrete nodes at creation)."""
    if not isinstance(strategy, PlacementGroupSchedulingStrategy):
        return strategy
    pg = strategy.placement_group
    idx = strategy.placement_group_bundle_index
    if idx < 0:
        idx = 0
    placement = pg.bundle_placement()
    node_id, _addr = placement[idx]
    return ("_pg", pg.id, idx, node_id)
