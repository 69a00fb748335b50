"""Small ``ray.util`` parity helpers.

Reference: ``python/ray/util/__init__.py`` — ``list_named_actors``
(GcsActorManager named-actor listing) and ``check_serialize.py`` —
``inspect_serializability`` (recursive cloudpickle failure triage).
"""

from __future__ import annotations

from typing import Any, List, Set, Tuple, Union


def list_named_actors(all_namespaces: bool = False,
                      namespace: str = "default"
                      ) -> Union[List[str], List[dict]]:
    """Names of all LIVE named actors (reference:
    ``ray.util.list_named_actors``).  Returns bare names for one
    namespace, ``{"namespace", "name"}`` dicts with ``all_namespaces``."""
    from ray_tpu_torch.core.core_worker import global_worker
    from ray_tpu_torch.core.rpc import run_async

    rows = run_async(global_worker().gcs.call(
        "list_named_actors", namespace=namespace,
        all_namespaces=all_namespaces))
    if all_namespaces:
        return rows
    return [r["name"] for r in rows]


def inspect_serializability(obj: Any, name: str | None = None,
                            ) -> Tuple[bool, Set[str]]:
    """Try to cloudpickle ``obj``; on failure, walk its closure/attrs to
    name the innermost unserializable pieces (reference:
    ``ray.util.inspect_serializability`` / ``check_serialize.py``).
    Returns ``(ok, failed_member_descriptions)`` and prints a short
    triage tree."""
    import cloudpickle

    name = name or getattr(obj, "__name__", repr(obj)[:60])
    failures: Set[str] = set()
    seen: Set[int] = set()  # cycle guard: self-referential objects

    def check(o, label, depth):
        if id(o) in seen:
            return False
        seen.add(id(o))
        try:
            cloudpickle.dumps(o)
            return True
        except Exception as e:
            print(f"{'  ' * depth}✗ {label}: {type(e).__name__}: {e}")
            found_inner = False
            # descend into the likely carriers of the poison pill
            closure = getattr(o, "__closure__", None) or ()
            freevars = getattr(getattr(o, "__code__", None),
                               "co_freevars", ())
            for var, cell in zip(freevars, closure):
                try:
                    inner = cell.cell_contents
                except ValueError:
                    continue
                if not check(inner, f"closure var {var!r}", depth + 1):
                    found_inner = True
            for attr in ("__dict__",):
                for k, v in (getattr(o, attr, None) or {}).items():
                    try:
                        cloudpickle.dumps(v)
                    except Exception:
                        found_inner = True
                        check(v, f"attribute {k!r}", depth + 1)
            if not found_inner:
                failures.add(label)
            return False

    ok = check(obj, name, 0)
    if ok:
        print(f"✓ {name} is serializable")
    return ok, failures
