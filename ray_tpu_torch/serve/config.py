"""Serve configs: deployment + autoscaling schemas.

Reference: ``python/ray/serve/config.py`` (DeploymentConfig/AutoscalingConfig
pydantic models) — re-expressed as plain dataclasses; and
``python/ray/serve/_private/common.py`` status enums.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


#: autoscaling policies: "ongoing" is the original ongoing-requests
#: heuristic; "slo" is the serve/slo_autoscaler.py control loop driven by
#: the serve.slo_signal() contract (TTFT-p95 vs target + queue depth per
#: replica, hysteresis, capacity-aware clamping, drain-aware scale-down)
POLICY_ONGOING = "ongoing"
POLICY_SLO = "slo"


@dataclasses.dataclass
class AutoscalingConfig:
    """Replica autoscaling.  ``policy="ongoing"`` is the queue-depth
    heuristic (reference: _private/autoscaling_policy.py — target ongoing
    requests per replica drives the count); ``policy="slo"`` drives the
    count from the ``serve.slo_signal()`` contract instead (see
    serve/slo_autoscaler.py): scale up fast when TTFT-p95 breaches
    ``ttft_p95_target_ms`` or queue depth per replica exceeds
    ``target_ongoing_requests``, scale down slowly (one replica at a time,
    emptiest first, through the graceful-drain path) once the signal has
    stayed under ``downscale_low_water`` of both targets for
    ``downscale_delay_s``."""
    min_replicas: int = 1
    max_replicas: int = 8
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    # smoothing factor applied to the raw desired count
    smoothing_factor: float = 1.0
    policy: str = POLICY_ONGOING
    #: SLO policy: TTFT-p95 above this is a breach (None = queue-only)
    ttft_p95_target_ms: Optional[float] = None
    #: SLO policy: don't trust TTFT percentiles computed over fewer
    #: rolling-window samples than this (a single slow request must not
    #: trigger a surge)
    min_window_n: int = 4
    #: SLO policy: downscale only when queue/replica AND TTFT-p95 sit
    #: below this fraction of their targets — the deadband between the
    #: upscale and downscale thresholds is the anti-flap hysteresis
    downscale_low_water: float = 0.5
    #: SLO policy: per-decision surge cap — one upscale step may at most
    #: multiply the replica count by this (breach ratio beyond it waits
    #: for the next control period, after the new replicas report in)
    upscale_surge_max: float = 2.0

    def __post_init__(self):
        if self.min_replicas < 1:
            # Scale-to-zero needs a pending-request signal at the controller
            # (requests route directly to replicas here, so a zero-replica
            # deployment could never wake up).  Reject rather than brick.
            raise ValueError("min_replicas must be >= 1 (scale-to-zero is "
                             "not supported: routing is direct-to-replica)")
        if self.policy not in (POLICY_ONGOING, POLICY_SLO):
            raise ValueError(f"unknown autoscaling policy {self.policy!r} "
                             f"(choose {POLICY_ONGOING!r} or {POLICY_SLO!r})")
        if not 0.0 < self.downscale_low_water < 1.0:
            raise ValueError("downscale_low_water must be in (0, 1) — it is "
                             "the hysteresis deadband's lower edge")


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 100
    user_config: Any = None
    autoscaling: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 10.0
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    route_prefix: Optional[str] = None  # default: f"/{name}"

    def initial_replicas(self) -> int:
        if self.autoscaling is not None:
            return max(self.autoscaling.min_replicas, 1)
        return self.num_replicas


# Deployment status values (reference: _private/common.py DeploymentStatus)
DEPLOYING = "DEPLOYING"
HEALTHY = "HEALTHY"
UNHEALTHY = "UNHEALTHY"
UPDATING = "UPDATING"
DELETING = "DELETING"
