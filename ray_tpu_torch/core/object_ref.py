"""ObjectRef — a future handle to a value in the distributed object store.

Mirrors the reference's ``ray.ObjectRef`` (``python/ray/_raylet.pyx`` ObjectRef class):
the ref carries its id plus the *owner's* RPC address (ownership-based object directory,
reference ``src/ray/object_manager/ownership_based_object_directory.h`` — the owner is
the source of truth for the value's location and lifetime).  Refs participate in
distributed reference counting: construction/destruction report to the process-local
ReferenceCounter (reference ``src/ray/core_worker/reference_count.h:61``).
"""

from __future__ import annotations

from typing import Optional

from .ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: str = "", _register: bool = True):
        self.id = object_id
        self.owner = owner  # rpc address of owning core worker ("" = local)
        self._registered = _register
        if _register:
            _ref_created(self)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self):
        return self.id.task_id()

    def future(self):
        """A concurrent.futures.Future resolved with the object's value."""
        from . import api
        return api.as_future(self)

    def __await__(self):
        from . import api
        return api.get_async(self).__await__()

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        # Plain pickle path (e.g. sending a ref through a non-ray channel).
        # Ray-internal serialization intercepts refs via persistent_id instead
        # so it can track borrowers.
        return (ObjectRef, (self.id, self.owner, False))

    def __del__(self):
        # Only refs that incremented the count on construction decrement it
        # (refs built with _register=False, e.g. transient lookups, must not
        # unbalance the count and free live objects).
        if not getattr(self, "_registered", False):
            return
        try:
            _ref_deleted(self)
        except Exception:
            pass


# Bound on first use (core_worker imports this module, so a top-level
# import would be circular).  These run once per ObjectRef construction
# and destruction — the repeated `from .core_worker import ...` module
# machinery showed up in submit-path profiles.
_global_worker_or_none = None


def _ref_created(ref: ObjectRef):
    global _global_worker_or_none
    if _global_worker_or_none is None:
        from .core_worker import \
            global_worker_or_none as _global_worker_or_none
    w = _global_worker_or_none()
    if w is not None:
        w.reference_counter.add_local_ref(ref.id, ref.owner)


def _ref_deleted(ref: ObjectRef):
    if _global_worker_or_none is None:
        return
    w = _global_worker_or_none()
    if w is not None:
        w.reference_counter.remove_local_ref(ref.id, ref.owner)
