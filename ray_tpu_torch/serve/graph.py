"""Model composition: deployment graphs.

Reference: ``python/ray/serve/dag.py`` + ``deployment_graph_build.py`` +
``drivers.py`` (DAGDriver) — deployments bind *other deployments* as init
args; ``serve.run(root)`` deploys the transitive closure and each replica
receives live :class:`DeploymentHandle`s where the graph had nested
deployments, so deployment-to-deployment calls route through the normal
handle path (power-of-two-choices, autoscaling, health checks all apply).

Example::

    @serve.deployment
    class Preprocess: ...

    @serve.deployment
    class Model:
        def __init__(self, pre):           # receives a DeploymentHandle
            self.pre = pre
        async def __call__(self, x):
            return model(await self.pre.remote(x).result_async())

    app = Model.bind(Preprocess.bind())
    serve.run(app)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from .deployment import Deployment


def _walk(value, fn):
    """Structurally map ``fn`` over Deployments nested in containers."""
    if isinstance(value, Deployment):
        return fn(value)
    if isinstance(value, list):
        return [_walk(v, fn) for v in value]
    if isinstance(value, tuple):
        return tuple(_walk(v, fn) for v in value)
    if isinstance(value, dict):
        return {k: _walk(v, fn) for k, v in value.items()}
    return value


def collect_deployments(root: Deployment) -> List[Deployment]:
    """The transitive closure of ``root`` over bound-arg edges, dependencies
    first (so inner deployments are deployed before the ones calling them).
    Two bound copies with the same name must be the same deployment."""
    seen: Dict[str, Deployment] = {}
    order: List[Deployment] = []

    def visit(d: Deployment):
        if d.name in seen:
            if seen[d.name].version() != d.version():
                raise ValueError(
                    f"two different deployments named {d.name!r} in one "
                    "graph; give them distinct name= options")
            return
        seen[d.name] = d
        _walk(list(d.init_args) + list(d.init_kwargs.values()), visit)
        order.append(d)  # post-order: dependencies first

    visit(root)
    return order


def resolve_handles(d: Deployment) -> Deployment:
    """Replace nested Deployments in init args with DeploymentHandles
    (picklable name-only stubs resolved inside the replica)."""
    from .router import DeploymentHandle

    def to_handle(dep: Deployment):
        return DeploymentHandle(dep.name)

    args = tuple(_walk(a, to_handle) for a in d.init_args)
    kwargs = {k: _walk(v, to_handle) for k, v in d.init_kwargs.items()}
    return dataclasses.replace(d, init_args=args, init_kwargs=kwargs)


class _DAGDriver:
    """HTTP ingress for a deployment graph (reference: serve/drivers.py).

    Deploy as ``serve.run(DAGDriver.bind(root.bind(...)))`` — requests hit
    the driver, which forwards to the root handle and awaits the result.
    """

    def __init__(self, target):
        self.target = target  # a DeploymentHandle after graph resolution

    async def __call__(self, request=None):
        resp = self.target.remote(request)
        if hasattr(resp, "result_async"):
            return await resp.result_async()
        return resp.result()


def _make_dag_driver() -> Deployment:
    # DAGDriver ships pre-decorated (reference: drivers.py DAGDriver is
    # itself a @serve.deployment) so `DAGDriver.bind(app)` works directly.
    from .deployment import deployment as _deployment
    return _deployment(_DAGDriver, name="DAGDriver")


DAGDriver = _make_dag_driver()
