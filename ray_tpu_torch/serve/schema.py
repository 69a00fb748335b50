"""Declarative Serve deploys: config file -> running applications.

Reference: ``python/ray/serve/schema.py`` (ServeDeploySchema /
ServeApplicationSchema) + ``serve/scripts.py`` (``serve deploy/run/status``).
A config is YAML or JSON:

.. code-block:: yaml

    applications:
      - name: adder
        import_path: my_pkg.apps:adder_app     # Deployment OR builder fn
        route_prefix: /adder
        args: {increment: 5}                    # kwargs for a builder fn
        deployments:                            # per-deployment overrides
          - name: Adder
            num_replicas: 2

``deploy_config`` builds each application (importing the target in-process,
like the reference's build step), applies overrides, and hands the result to
``serve.run``; re-deploying an updated config rolls deployments forward
through the controller's reconcile loop.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Dict, List, Optional

from .deployment import Deployment


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        return yaml.safe_load(text)
    return json.loads(text)


def import_target(import_path: str):
    """``module.sub:attr`` -> the attribute (reference: import_attr)."""
    if ":" not in import_path:
        raise ValueError(
            f"import_path must look like 'module:attr', got {import_path!r}")
    mod_name, attr = import_path.split(":", 1)
    mod = importlib.import_module(mod_name)
    target = mod
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def build_application(app_cfg: Dict[str, Any]) -> Deployment:
    """Resolve one application entry to a bound Deployment."""
    target = import_target(app_cfg["import_path"])
    if isinstance(target, Deployment):
        app = target
    elif callable(target):
        app = target(**(app_cfg.get("args") or {}))
        if not isinstance(app, Deployment):
            raise TypeError(
                f"builder {app_cfg['import_path']} returned "
                f"{type(app).__name__}, expected a Deployment")
    else:
        raise TypeError(f"{app_cfg['import_path']} is neither a Deployment "
                        "nor a builder callable")
    overrides = {d["name"]: d for d in app_cfg.get("deployments") or []}
    ov = overrides.get(app.name)
    cfg = app.config
    if ov:
        fields = {k: v for k, v in ov.items()
                  if k in {"num_replicas", "max_concurrent_queries",
                           "health_check_period_s",
                           "user_config"} and v is not None}
        # the DeploymentConfig field is `autoscaling`; the config-file key
        # keeps the reference's `autoscaling_config` spelling (a dict,
        # e.g. {policy: slo, ttft_p95_target_ms: 500})
        if ov.get("autoscaling_config") is not None:
            from .config import AutoscalingConfig
            ac = ov["autoscaling_config"]
            fields["autoscaling"] = (
                ac if isinstance(ac, AutoscalingConfig)
                else AutoscalingConfig(**ac))
        cfg = dataclasses.replace(cfg, **fields)
    if app_cfg.get("route_prefix"):
        cfg = dataclasses.replace(cfg, route_prefix=app_cfg["route_prefix"])
    return dataclasses.replace(app, config=cfg)


def deploy_config(config: Dict[str, Any], *, blocking: bool = True,
                  timeout_s: float = 120.0) -> List[str]:
    """Deploy every application in the config; returns deployed app names."""
    from . import api as serve_api

    apps = config.get("applications")
    if not apps:
        raise ValueError("config has no 'applications' list")
    names = []
    for app_cfg in apps:
        app = build_application(app_cfg)
        serve_api.run(app, route_prefix=app.config.route_prefix
                      or f"/{app.name}", timeout_s=timeout_s,
                      _blocking=blocking)
        names.append(app_cfg.get("name", app.name))
    return names


def status_summary() -> Dict[str, Any]:
    """Deployment-status map for `serve status` / GET /api/serve."""
    from . import api as serve_api
    try:
        return serve_api.status()
    except Exception:
        return {}
