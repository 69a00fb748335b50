"""ray_tpu_torch.serve — model serving on the actor substrate.

Capabilities of Ray Serve (reference: ``python/ray/serve/``): deployments as
reconciled replica actor sets, rolling updates, health-driven replacement,
queue-depth autoscaling, power-of-two-choices routing, dynamic batching,
streaming responses, an HTTP ingress with ASGI-app mounting
(``@serve.ingress`` — any ASGI-3 callable, routes/middleware/SSE), and a
gRPC ingress (``grpc_proxy.py``, schema in ``protos/serve.proto``) — plus
a TPU-first continuous-batching LLM deployment (``ray_tpu_torch.serve.llm``).
"""

from .api import (autoscale_decisions, delete, get_deployment_handle,
                  grpc_config, http_config, run, shutdown, slo_signal, start,
                  status)
from .asgi import ASGIApp, ASGIRequest, ingress
from .batching import batch
from .multiplex import get_multiplexed_model_id, multiplexed
from .config import AutoscalingConfig, DeploymentConfig
from .deployment import Deployment, deployment
from .graph import DAGDriver
from .replica import Request
from .router import DeploymentHandle

__all__ = [
    "deployment", "Deployment", "DeploymentConfig", "AutoscalingConfig",
    "DeploymentHandle", "Request", "batch", "run", "start", "status",
    "delete", "shutdown", "get_deployment_handle", "http_config",
    "multiplexed", "get_multiplexed_model_id", "DAGDriver",
    "ingress", "ASGIApp", "ASGIRequest", "grpc_config", "slo_signal",
    "autoscale_decisions",
]

# Usage telemetry: which libraries a cluster actually uses (reference:
# usage_lib.record_library_usage at import time).  Never raises.
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("serve")
del _rlu
