"""DAG nodes: lazy ``.bind()`` graphs over tasks and actors.

Reference: ``python/ray/dag/dag_node.py`` (DAGNode ABC + execute),
``function_node.py``, ``class_node.py``, ``input_node.py``.  Semantics kept:
``bind`` captures args (which may be other nodes), ``execute`` resolves the
graph bottom-up, one task/actor call per node, sharing results across fan-out
(a node consumed twice runs once).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """A lazily-bound call in the graph."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._uuid = uuid.uuid4().hex

    # -- graph walking ----------------------------------------------------

    def _upstream(self) -> List["DAGNode"]:
        out = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for v in self._bound_kwargs.values():
            scan(v)
        return out

    def _resolve_args(self, memo: Dict[str, Any]):
        def sub(v):
            if isinstance(v, DAGNode):
                return memo[v._uuid]
            if isinstance(v, list):
                return [sub(x) for x in v]
            if isinstance(v, tuple):
                return tuple(sub(x) for x in v)
            if isinstance(v, dict):
                return {k: sub(x) for k, x in v.items()}
            return v

        args = tuple(sub(a) for a in self._bound_args)
        kwargs = {k: sub(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _apply(self, args, kwargs, memo: Dict[str, Any]):
        raise NotImplementedError

    # -- execution --------------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Walk the DAG; returns this node's result ref (``ray_tpu_torch.get``
        it) or value.  Each node executes exactly once per call."""
        memo: Dict[str, Any] = {}
        order: List[DAGNode] = []
        seen = set()

        def topo(n: DAGNode):
            if n._uuid in seen:
                return
            seen.add(n._uuid)
            for up in n._upstream():
                topo(up)
            order.append(n)

        topo(self)
        for node in order:
            if isinstance(node, InputNode):
                if len(input_args) == 1 and not input_kwargs:
                    memo[node._uuid] = input_args[0]
                else:
                    memo[node._uuid] = (input_args, input_kwargs)
                continue
            args, kwargs = node._resolve_args(memo)
            memo[node._uuid] = node._apply(args, kwargs, memo)
        return memo[self._uuid]


class InputNode(DAGNode):
    """The runtime input placeholder (reference: input_node.py).  Usable as
    a context manager for parity with the reference's idiom::

        with InputNode() as inp:
            dag = f.bind(inp)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    """``remote_fn.bind(...)`` (reference: function_node.py)."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _apply(self, args, kwargs, memo):
        return self._fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """``ActorClass.bind(...)`` — the actor is created at execute time; its
    methods are bound via attribute access (reference: class_node.py)."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._cls = actor_cls

    def _apply(self, args, kwargs, memo):
        return self._cls.remote(*args, **kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodStub(self, name)


class _MethodStub:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method = method

    def _upstream(self):
        return [self._class_node] + super()._upstream()

    def _apply(self, args, kwargs, memo):
        actor = memo[self._class_node._uuid]
        return getattr(actor, self._method).remote(*args, **kwargs)
