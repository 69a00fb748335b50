"""Deployment: the user-facing unit of Serve.

Reference: ``python/ray/serve/deployment.py:102`` (Deployment dataclass) and
``api.py:266`` (@serve.deployment).  A Deployment wraps a class (or function),
its init args, and a DeploymentConfig; ``serve.run`` ships it to the
controller which reconciles replica actors.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Tuple

import cloudpickle

from .config import AutoscalingConfig, DeploymentConfig


@dataclasses.dataclass
class Deployment:
    func_or_class: Callable
    name: str
    config: DeploymentConfig
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        name = kwargs.pop("name", self.name)
        for k, v in kwargs.items():
            if k == "autoscaling_config":
                cfg.autoscaling = (v if isinstance(v, (AutoscalingConfig,
                                                      type(None)))
                                   else AutoscalingConfig(**v))
            elif hasattr(cfg, k):
                setattr(cfg, k, v)
            else:
                raise TypeError(f"unknown deployment option {k!r}")
        return dataclasses.replace(self, name=name, config=cfg)

    def bind(self, *args, **kwargs) -> "Deployment":
        """Fix init args (reference: deployment DAG .bind)."""
        return dataclasses.replace(self, init_args=args, init_kwargs=kwargs)

    def app_blob(self) -> bytes:
        """Serialized (callable, init_args, init_kwargs) shipped to replicas."""
        return cloudpickle.dumps(
            (self.func_or_class, self.init_args, self.init_kwargs))

    def version(self) -> str:
        """Code+config hash driving rolling updates: replicas whose version
        differs from the target version get replaced (reference:
        _private/deployment_state.py version tracking)."""
        h = hashlib.sha256(self.app_blob())
        h.update(repr(dataclasses.asdict(self.config)).encode())
        return h.hexdigest()[:12]


def deployment(_func_or_class: Optional[Callable] = None, *,
               name: Optional[str] = None, num_replicas: int = 1,
               max_concurrent_queries: int = 100,
               user_config: Any = None,
               autoscaling_config: Optional[Any] = None,
               health_check_period_s: float = 2.0,
               health_check_timeout_s: float = 10.0,
               graceful_shutdown_timeout_s: float = 10.0,
               route_prefix: Optional[str] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None):
    """``@serve.deployment`` decorator (reference: serve/api.py:266)."""

    def wrap(func_or_class: Callable) -> Deployment:
        auto = autoscaling_config
        if auto is not None and not isinstance(auto, AutoscalingConfig):
            auto = AutoscalingConfig(**auto)
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            autoscaling=auto,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=dict(ray_actor_options or {}),
            route_prefix=route_prefix,
        )
        return Deployment(func_or_class=func_or_class,
                          name=name or getattr(func_or_class, "__name__",
                                               "deployment"),
                          config=cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
