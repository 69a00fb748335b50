"""ray_tpu_torch.util — utility layer over the core runtime.

Reference surface: ``python/ray/util`` — ActorPool, Queue, collective,
scheduling strategies (those live in ray_tpu_torch.core), state API
(ray_tpu_torch.util.state).
"""

from .actor_pool import ActorPool
from .misc import inspect_serializability, list_named_actors
from .pubsub import Subscriber, publish
from .queue import Empty, Full, Queue

__all__ = ["ActorPool", "Queue", "Empty", "Full", "Subscriber", "publish",
           "list_named_actors", "inspect_serializability"]
