"""Serve public API: start/run/status/delete/shutdown + handles.

Reference: ``python/ray/serve/api.py`` (:68 serve.start, :480 serve.run) — the
user surface over the controller.  ``serve.run`` ships Deployments to the
controller actor and blocks until every deployment reports HEALTHY.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import ray_tpu_torch

from .config import HEALTHY
from .controller import CONTROLLER_NAME, ServeController
from .deployment import Deployment
from .http_proxy import PROXY_NAME, HTTPProxyActor
from .router import DeploymentHandle, reset_router


def _get_controller(create: bool = False, http: bool = False,
                    http_host: str = "127.0.0.1", http_port: int = 0,
                    grpc: bool = False, grpc_port: int = 0):
    ctrl = None
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        if not create:
            raise RuntimeError(
                "Serve is not running; call serve.start() or serve.run()")
    if ctrl is None:
        ctrl = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, lifetime="detached", max_concurrency=1000,
            num_cpus=0.1, get_if_exists=True).remote()
        ray_tpu_torch.get(ctrl.startup.remote(), timeout=30)
    if http and ray_tpu_torch.get(ctrl.get_http_config.remote(), timeout=30) is None:
        proxy = ray_tpu_torch.remote(HTTPProxyActor).options(
            name=PROXY_NAME, lifetime="detached", max_concurrency=1000,
            num_cpus=0.1, get_if_exists=True).remote(http_host, http_port)
        port = ray_tpu_torch.get(proxy.ready.remote(), timeout=30)
        ray_tpu_torch.get(ctrl.set_http_config.remote(
            {"host": http_host, "port": port}), timeout=30)
    if grpc:
        from .grpc_proxy import GRPC_PROXY_NAME, GrpcProxyActor
        gproxy = ray_tpu_torch.remote(GrpcProxyActor).options(
            name=GRPC_PROXY_NAME, lifetime="detached", max_concurrency=1000,
            num_cpus=0.1, get_if_exists=True).remote(http_host, grpc_port)
        ray_tpu_torch.get(gproxy.ready.remote(), timeout=30)
    return ctrl


def start(detached: bool = True, http_options: Optional[dict] = None,
          grpc_options: Optional[dict] = None):
    """Start the Serve control plane: controller + optional HTTP proxy +
    optional gRPC proxy (reference serve.start's gRPCOptions)."""
    http_options = http_options or {}
    return _get_controller(
        create=True, http=bool(http_options),
        http_host=http_options.get("host", "127.0.0.1"),
        http_port=http_options.get("port", 0),
        grpc=grpc_options is not None,
        grpc_port=(grpc_options or {}).get("port", 0))


def run(target: Union[Deployment, Dict[str, Deployment]], *,
        route_prefix: Optional[str] = "/__auto__",
        http: bool = False, timeout_s: float = 60.0,
        _blocking: bool = True) -> DeploymentHandle:
    """Deploy and wait until healthy; returns a handle to the (first)
    deployment (reference: serve.run returns the app handle)."""
    from .graph import collect_deployments, resolve_handles
    # expand deployment graphs: nested Deployments in bound init args
    # become DeploymentHandles; dependencies deploy first so the root
    # never routes to a missing deployment (reference:
    # deployment_graph_build.py).  Dict targets expand each value's graph.
    roots = [target] if isinstance(target, Deployment) \
        else list(target.values())
    seen: Dict[str, Deployment] = {}
    for r in roots:
        for d in collect_deployments(r):
            prev = seen.get(d.name)
            if prev is not None and prev.version() != d.version():
                raise ValueError(
                    f"two different deployments named {d.name!r}; "
                    "give them distinct name= options")
            seen.setdefault(d.name, d)
    deployments = [resolve_handles(d) for d in seen.values()]
    root_name = roots[0].name if roots else None
    if not deployments:
        raise ValueError("nothing to deploy")
    if route_prefix != "/__auto__" and isinstance(target, Deployment):
        import dataclasses
        deployments = [
            dataclasses.replace(d, config=dataclasses.replace(
                d.config, route_prefix=route_prefix))
            if d.name == root_name else d
            for d in deployments]
    ctrl = _get_controller(create=True, http=http)
    for d in deployments:
        ray_tpu_torch.get(ctrl.deploy.remote(d), timeout=30)
    if _blocking:
        _wait_healthy(ctrl, [d.name for d in deployments], timeout_s)
    return DeploymentHandle(root_name)


def _wait_healthy(ctrl, names, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status = ray_tpu_torch.get(ctrl.get_status.remote(), timeout=30)
        if all(status.get(n, {}).get("status") == HEALTHY for n in names):
            return
        time.sleep(0.1)
    raise TimeoutError(
        f"deployments {names} not healthy after {timeout_s}s: "
        f"{ray_tpu_torch.get(ctrl.get_status.remote(), timeout=30)}")


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> dict:
    ctrl = _get_controller()
    return ray_tpu_torch.get(ctrl.get_status.remote(), timeout=30)


def slo_signal() -> dict:
    """Per-deployment SLO signal (queue depth + rolling p50/p95/p99 TTFT
    from the replicas' heartbeat windows, with stale snapshots dropped
    and counted as ``stale_replicas``) — the documented input contract
    for SLO-driven autoscaling, consumed by the ``policy="slo"``
    autoscaler (serve/slo_autoscaler.py).  Same data ``raytpu serve
    status`` tables and ``/api/serve`` embed."""
    ctrl = _get_controller()
    return ray_tpu_torch.get(ctrl.get_serve_signal.remote(), timeout=30)


def autoscale_decisions(deployment: Optional[str] = None,
                        limit: int = 50) -> list:
    """Tail of the autoscaler's bounded decision ring (newest last): one
    record per scale event — {ts, deployment, policy, direction, reason,
    from_replicas, to_replicas, wanted, capped, signal} — including
    capacity-capped asks ("wanted N, cluster capped at M").  Also
    surfaced by ``raytpu serve status`` and ``GET /api/serve/autoscale``."""
    ctrl = _get_controller()
    return ray_tpu_torch.get(ctrl.get_autoscale_decisions.remote(
        deployment=deployment, limit=limit), timeout=30)


def http_config() -> Optional[dict]:
    ctrl = _get_controller()
    return ray_tpu_torch.get(ctrl.get_http_config.remote(), timeout=30)


def grpc_config() -> Optional[dict]:
    from .grpc_proxy import GRPC_PROXY_NAME
    try:
        gproxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME)
    except Exception:
        return None
    return ray_tpu_torch.get(gproxy.get_config.remote(), timeout=30)


def delete(name: str, timeout_s: float = 30.0):
    ctrl = _get_controller()
    ray_tpu_torch.get(ctrl.delete_deployment.remote(name), timeout=30)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if name not in ray_tpu_torch.get(ctrl.get_status.remote(), timeout=30):
            return
        time.sleep(0.1)
    raise TimeoutError(f"deployment {name} still present after {timeout_s}s")


def shutdown():
    """Tear down the control plane: drain replicas, stop proxy + controller."""
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        reset_router()
        return
    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME)
        ray_tpu_torch.get(proxy.drain.remote(), timeout=10)
        ray_tpu_torch.kill(proxy)
    except Exception:
        pass
    try:
        from .grpc_proxy import GRPC_PROXY_NAME
        gproxy = ray_tpu_torch.get_actor(GRPC_PROXY_NAME)
        ray_tpu_torch.get(gproxy.drain.remote(), timeout=10)
        ray_tpu_torch.kill(gproxy)
    except Exception:
        pass
    try:
        ray_tpu_torch.get(ctrl.graceful_shutdown.remote(), timeout=60)
    except Exception:
        pass
    try:
        ray_tpu_torch.kill(ctrl)
    except Exception:
        pass
    reset_router()
