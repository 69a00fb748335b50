"""Topic pub/sub client API over the GCS long-poll channel.

Reference: ``src/ray/pubsub/`` (``Publisher``/``Subscriber``) and the Python
facade ``ray._raylet.GcsSubscriber`` — long-poll based delivery of one-way
pushes per topic.  The GCS side lives in ``ray_tpu_torch/core/gcs.py``
(``handle_publish`` / ``handle_pubsub_poll``); this module is the public
client surface: ``publish(topic, payload)`` fans a message out to every
``Subscriber`` polling that topic anywhere in the cluster.

Used internally by the log streamer (``core/api.py``), the runtime-env
broadcaster, and actor/node state notifications; exposed publicly for user
code (e.g. cross-job coordination, dashboards).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from ..core.rpc import RpcClient, run_async

_FAR_FUTURE_CURSOR = 1 << 60


def _gcs_address(explicit: Optional[str]) -> str:
    if explicit:
        return explicit
    from ..core import api
    worker = api._state.worker
    if worker is None:
        raise RuntimeError("ray_tpu_torch.init() first, or pass gcs_address=")
    return worker.gcs_address


def publish(topic: str, payload: Any, gcs_address: Optional[str] = None) -> int:
    """Publish ``payload`` on ``topic``; returns the event sequence number."""
    client = RpcClient(_gcs_address(gcs_address))
    try:
        return run_async(client.call("publish", topic=topic, payload=payload))
    finally:
        run_async(client.close())


class Subscriber:
    """Long-poll subscriber for one or more topics.

    ``poll()`` blocks until at least one new message arrives (or the timeout
    elapses) and returns ``[(topic, payload), ...]`` in publish order.  A
    fresh subscriber starts at "now": messages published before construction
    are not replayed (matching the reference's subscribe-then-receive
    semantics, not a durable log).
    """

    def __init__(self, topics: List[str] | str,
                 gcs_address: Optional[str] = None):
        self.topics = [topics] if isinstance(topics, str) else list(topics)
        self._client = RpcClient(_gcs_address(gcs_address))
        self._closed = False
        # Poll with an impossible cursor to learn the current seq ("now").
        # The probe must not silently fall back to cursor 0 — that would
        # replay retained history, violating the documented start-at-now
        # semantics — so retry once and then surface the failure.
        last_err = None
        for _ in range(2):
            try:
                self._cursor, _ = run_async(self._client.call(
                    "pubsub_poll", topics=self.topics,
                    cursor=_FAR_FUTURE_CURSOR, timeout=0.01))
                break
            except Exception as e:
                last_err = e
                time.sleep(0.2)
        else:
            raise RuntimeError(
                f"pubsub cursor probe failed (GCS unreachable?): {last_err}")

    def poll(self, timeout: float = 30.0) -> List[Tuple[str, Any]]:
        deadline = time.monotonic() + timeout
        while not self._closed:
            step = max(0.0, deadline - time.monotonic())
            self._cursor, events = run_async(
                self._client.call("pubsub_poll", topics=self.topics,
                                  cursor=self._cursor,
                                  timeout=min(step, 30.0)),
                timeout=min(step, 30.0) + 10.0)
            if events:
                return [(t, p) for _seq, t, p in events]
            if time.monotonic() >= deadline:
                return []
        return []

    def close(self):
        self._closed = True
        try:
            run_async(self._client.close(), timeout=2.0)
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
