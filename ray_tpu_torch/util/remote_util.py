"""Small shared helpers for modules that submit tasks lazily."""

from __future__ import annotations


def lazy_remote(fn):
    """Wrap ``fn`` as a remote function on first use, cached on the
    function object — lets library modules (darray, daskcompat) submit
    tasks without requiring an initialized runtime at import time."""
    import ray_tpu_torch
    if not hasattr(fn, "_lazy_remote"):
        fn._lazy_remote = ray_tpu_torch.remote(fn)
    return fn._lazy_remote
