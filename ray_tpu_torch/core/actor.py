"""Actors: ActorClass / ActorHandle / ActorMethod.

Reference: ``python/ray/actor.py`` — ``ActorClass`` (:384), ``ActorClass._remote``
(:667; ``max_restarts``/``max_task_retries`` :333-352), ``ActorHandle`` (:1025).
Creation goes through the GCS (centralized, fault-tolerant); method calls are
peer-to-peer RPC to the actor's worker (reference call stack §3.3 of SURVEY).
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Any, Dict, List, Optional

from . import serialization
from .common import (STREAMING_RETURNS, TaskSpec, build_spec_from_template,
                     copy_spec_into)
from .config import get_config
from .ids import ActorID, TaskID
from .object_ref import ObjectRef
from .remote_function import (_current_trace_ctx, resolve_pg_strategy,
                              serialize_args)
from .rpc import run_async

# Bound on first method submit (core_worker imports this module, so a
# top-level import would be circular).
_global_worker = None


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1, generator_backpressure: int = 0):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._generator_backpressure = generator_backpressure

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(self._handle, self._name,
                        opts.get("num_returns", self._num_returns),
                        opts.get("generator_backpressure",
                                 self._generator_backpressure))
        return m

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(self._name, args, kwargs,
                                           self._num_returns,
                                           self._generator_backpressure)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; "
            f"use '.{self._name}.remote()'.")


class ActorHandle:
    def __init__(self, actor_id: str, method_names: List[str],
                 max_task_retries: int = 0, name: Optional[str] = None):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_method_names", list(method_names))
        object.__setattr__(self, "_max_task_retries", max_task_retries)
        object.__setattr__(self, "_name", name)
        #: warm-path method-call spec templates: (method, num_returns,
        #: backpressure) -> (generation_key, template) — bounded by the
        #: actor's method count (stale generations overwrite in place)
        object.__setattr__(self, "_spec_tmpls", {})

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        if item not in self._method_names:
            raise AttributeError(
                f"actor has no method {item!r}; methods: {self._method_names}")
        return ActorMethod(self, item)

    def _submit_method(self, method: str, args, kwargs, num_returns,
                       generator_backpressure: int = 0):
        global _global_worker
        if _global_worker is None:  # deferred: core_worker imports us
            from .core_worker import global_worker as _global_worker
        w = _global_worker()
        cfg = get_config()
        if num_returns in ("streaming", "dynamic"):
            num_returns = STREAMING_RETURNS
        args_blob, arg_refs = serialize_args(args, kwargs)
        # Warm path: the method descriptor (actor id, method name, options)
        # is call-invariant — clone the cached template (pooled slot copy)
        # instead of running the TaskSpec ctor per call.  The generation
        # key pins it to this worker + config object (reinit/set_config
        # rebuilds in place).
        key = (method, num_returns, int(generator_backpressure or 0))
        gen = (w.worker_id, id(cfg))
        hit = self._spec_tmpls.get(key)
        if (hit is not None and hit[0] == gen
                and cfg.submit_plane_native_enabled):
            spec = build_spec_from_template(
                hit[1], TaskID.from_random(), args_blob,
                _current_trace_ctx())
        else:
            spec = TaskSpec(
                task_id=TaskID.from_random(),
                job_id=w.job_id,
                name=f"{method}",
                fn_id=None,
                args=args_blob,
                num_returns=num_returns,
                owner=w.address,
                is_actor_task=True,
                actor_id=ActorID.from_hex(self._actor_id),
                actor_method=method,
                max_retries=self._max_task_retries,
                generator_backpressure=int(generator_backpressure or 0),
                trace_ctx=_current_trace_ctx(),
            )
            if cfg.submit_plane_native_enabled:
                tmpl = TaskSpec.__new__(TaskSpec)
                copy_spec_into(spec, tmpl)
                self._spec_tmpls[key] = (gen, tmpl)
        refs = w.submit_actor_task(self._actor_id, spec, arg_refs)
        if num_returns == STREAMING_RETURNS:
            return refs  # an ObjectRefGenerator
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names,
                              self._max_task_retries, self._name))

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:12]}, name={self._name!r})"


class ActorClass:
    def __init__(self, cls, default_options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._opts = dict(default_options or {})
        self._blob: Optional[bytes] = None
        self._fn_id: Optional[bytes] = None
        self._registered_in: set = set()
        self.__name__ = cls.__name__

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(opts)
        ac = ActorClass(self._cls, merged)
        ac._blob, ac._fn_id = self._blob, self._fn_id
        return ac

    def bind(self, *args, **kwargs):
        """Lazy DAG node: the actor is created at dag.execute() time
        (reference: dag/class_node.py)."""
        from ..dag import ClassNode
        return ClassNode(self, args, kwargs)

    def _ensure_registered(self, worker) -> bytes:
        if self._blob is None:
            self._blob = serialization.dumps_function(self._cls)
            self._fn_id = hashlib.sha1(self._blob).digest()[:16]
        key = id(worker)
        if key not in self._registered_in:
            run_async(worker.gcs.call_retry(
                "kv_put", ns="funcs", key=self._fn_id.hex(),
                value=self._blob, overwrite=False))
            self._registered_in.add(key)
        return self._fn_id

    def _method_names(self) -> List[str]:
        return [n for n, m in inspect.getmembers(self._cls)
                if callable(m) and not n.startswith("_")]

    def _is_async(self) -> bool:
        # async generator methods (streaming returns) make an actor async just
        # like coroutine methods do.
        return any(inspect.iscoroutinefunction(m)
                   or inspect.isasyncgenfunction(m)
                   for _, m in inspect.getmembers(self._cls) if callable(m))

    def remote(self, *args, **kwargs) -> ActorHandle:
        from .core_worker import global_worker
        w = global_worker()
        fn_id = self._ensure_registered(w)
        o = self._opts
        resources = dict(o.get("resources") or {})
        resources["CPU"] = float(o.get("num_cpus", 1))
        if o.get("num_gpus"):
            resources["GPU"] = float(o["num_gpus"])
        strategy = resolve_pg_strategy(o.get("scheduling_strategy", "DEFAULT"))
        args_blob, arg_refs = serialize_args(args, kwargs)
        actor_id = ActorID.from_random()
        lifetime = o.get("lifetime")
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            job_id=w.job_id,
            name=self.__name__,
            fn_id=fn_id,
            args=args_blob,
            num_returns=1,
            resources=resources,
            owner=w.address,
            scheduling_strategy=strategy,
            is_actor_creation=True,
            actor_id=actor_id,
            max_restarts=int(o.get("max_restarts", 0)),
            max_task_retries=int(o.get("max_task_retries", 0)),
            max_concurrency=int(o.get("max_concurrency",
                                      100 if self._is_async() else 1)),
            is_async_actor=self._is_async(),
            actor_name=o.get("name"),
            namespace=o.get("namespace"),
            lifetime=lifetime,
            runtime_env=o.get("runtime_env"),
        )
        # get_if_exists resolves ATOMICALLY in the GCS register handler —
        # concurrent get-or-create callers race at the single serialization
        # point and losers receive the winner's actor id (no client-side
        # pre-check TOCTOU).
        get_if_exists = bool(o.get("get_if_exists") and o.get("name"))
        aid = w.create_actor(spec, get_if_exists=get_if_exists)
        # Stash method names in GCS so get_actor() can rebuild handles.
        run_async(w.gcs.call_retry(
            "kv_put", ns="actor_meta", key=aid,
            value=serialization.dumps(
                {"methods": self._method_names(),
                 "max_task_retries": spec.max_task_retries})))
        return ActorHandle(aid, self._method_names(), spec.max_task_retries,
                           o.get("name"))

    def __call__(self, *a, **kw):
        raise TypeError(f"Actor class {self.__name__} cannot be instantiated "
                        f"directly; use {self.__name__}.remote()")


class ActorExitRequest(BaseException):
    """Raised by ``exit_actor()``; recognized by the executor as an
    INTENDED termination (BaseException so a method's broad ``except
    Exception`` cannot swallow the exit — same reasoning as SystemExit)."""


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: ``ray.actor.exit_actor``).  The in-flight call fails with
    a typed intended-exit ActorDiedError, the actor is marked DEAD with
    no restart (even with ``max_restarts``), and the worker process
    exits."""
    from .core_worker import global_worker_or_none
    w = global_worker_or_none()
    if w is None or w.actor_instance is None:
        raise RuntimeError("exit_actor() called outside an actor method")
    raise ActorExitRequest()


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    from .core_worker import global_worker
    w = global_worker()
    info = run_async(w.gcs.call("get_actor_info", name=name, namespace=namespace))
    if info is None or info["state"] == "DEAD":
        raise ValueError(f"actor {name!r} not found in namespace {namespace!r}")
    meta_blob = run_async(w.gcs.call("kv_get", ns="actor_meta",
                                     key=info["actor_id"]))
    meta = serialization.loads(meta_blob) if meta_blob else {"methods": [],
                                                             "max_task_retries": 0}
    return ActorHandle(info["actor_id"], meta["methods"],
                       meta["max_task_retries"], name)
