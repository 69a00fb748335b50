"""RLlib's actor classes on the port's runtime.

The reference places its runners, workers, replay shards and learners as
``ray_tpu.remote`` actors; the port places them as ``ray_tpu_torch.remote``
actors.  ``actor_class`` adds what the reference's configs carry and never
apply, ``debugging(worker_env=...)``: each actor sets those environment
variables in its process before it builds its instance.  A worker process
imports torch before the constructor runs (unpickling the class does), so
``OMP_NUM_THREADS`` is also applied through ``torch.set_num_threads``;
variables read only when a library loads belong in ``init(worker_env=...)``.
"""

from __future__ import annotations

from typing import Dict, Optional


def actor_class(cls, worker_env: Optional[Dict[str, str]] = None):
    """``ray_tpu_torch.remote(cls)``, with ``worker_env`` set in the actor's
    process before ``cls.__init__`` runs."""
    import ray_tpu_torch

    if not worker_env:
        return ray_tpu_torch.remote(cls)
    env = {str(k): str(v) for k, v in worker_env.items()}

    class WithEnv(cls):
        def __init__(self, *args, **kwargs):
            import os

            os.environ.update(env)
            if "OMP_NUM_THREADS" in env:
                import torch

                torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
            super().__init__(*args, **kwargs)

    WithEnv.__name__ = cls.__name__
    return ray_tpu_torch.remote(WithEnv)


def kill_all(handles) -> None:
    """``ray_tpu_torch.kill`` each handle, as the reference's ``stop()``s
    do: an actor already gone is no error."""
    import ray_tpu_torch

    for h in handles:
        try:
            ray_tpu_torch.kill(h)
        except Exception:
            pass
