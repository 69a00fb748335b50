"""Runtime context — ids and resources visible to running code.

Reference: ``python/ray/runtime_context.py`` (job/task/actor/node ids, assigned
resources).  Task-scoped fields use a contextvar set by the executor.
"""

from __future__ import annotations

import contextvars
from typing import Optional

_task_context: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "raytpu_task_context", default=None)


class RuntimeContext:
    @property
    def _worker(self):
        from .core_worker import global_worker
        return global_worker()

    def get_job_id(self) -> str:
        ctx = _task_context.get()
        if ctx:
            return ctx["job_id"].hex()
        return self._worker.job_id.hex()

    def get_task_id(self) -> Optional[str]:
        ctx = _task_context.get()
        return ctx["task_id"].hex() if ctx else None

    def get_actor_id(self) -> Optional[str]:
        ctx = _task_context.get()
        if ctx and ctx.get("actor_id"):
            return ctx["actor_id"].hex()
        w = self._worker
        return w.actor_spec.actor_id.hex() if w.actor_spec else None

    def get_node_id(self) -> Optional[str]:
        return self._worker.node_id

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_assigned_resources(self) -> dict:
        """The resource amounts this task/actor was scheduled with
        (reference: ``runtime_context.get_assigned_resources``)."""
        ctx = _task_context.get()
        if ctx and "resources" in ctx:
            return dict(ctx["resources"]) or {"CPU": 1.0}
        w = self._worker
        if w.actor_spec is not None:
            return dict(w.actor_spec.resources or {}) or {"CPU": 1.0}
        return {}

    def get_accelerator_ids(self) -> dict:
        """Accelerator ids visible to this worker (reference:
        ``get_accelerator_ids``/``get_gpu_ids`` — here the CUDA devices
        from CUDA_VISIBLE_DEVICES).  The runtime does not set that variable
        per lease, as the JAX package never sets TPU_VISIBLE_CHIPS per
        worker: it comes from the node's or ``init(worker_env=...)``'s
        environment."""
        import os
        raw = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        return {"GPU": [c.strip() for c in raw.split(",") if c.strip()]}

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get(self) -> dict:
        return {"job_id": self.get_job_id(), "task_id": self.get_task_id(),
                "actor_id": self.get_actor_id(), "node_id": self.get_node_id(),
                "worker_id": self.get_worker_id()}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
