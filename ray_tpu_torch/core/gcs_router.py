"""Client-side routing plane for the horizontally sharded GCS.

The control plane splits into a **router** (``core/gcs.py`` — everything
that needs global ordering: node table, jobs, actor registration, PG 2PC,
pubsub seq space) and N **shard processes** (``core/gcs_shard.py`` — the
hot, key-partitionable traffic: namespaced KV, task-event / object-event /
sched-decision fan-in rings).  This module is the one place shard
assignment is computed and the facade every runtime process talks to the
control plane through:

* :func:`shard_index` — THE partition helper.  Every cross-shard routing
  decision (client side, router proxy side, shard-side validation) goes
  through it; an AST lint (tests/test_metric_naming.py) rejects hand-hashed
  ``crc32(...) % shards`` expressions anywhere else, so client and server
  can never disagree about who owns a key.
* :class:`ShardedGcsClient` — an :class:`~ray_tpu_torch.core.rpc.RpcClient`-
  compatible facade (``call`` / ``call_retry`` / ``notify`` / ``close`` /
  ``.address``) that sends shard-routable methods client->shard direct by
  key and everything else to the router.  The shard map is fetched lazily
  and in the background; until it arrives every call goes to the router,
  which proxies — so routing is a fast path, never a correctness
  requirement, and legacy clients (a bare RpcClient at the router address)
  keep working unchanged.

Reference: the source system's GCS is backed by sharded Redis tables
(``gcs_table_storage.cc``) with clients routed by key hash; this is the
multi-process analogue of promoting ``core/sharded_table.py``'s in-process
partition lines to process boundaries (Ray paper: the GCS "can be scaled
by sharding").
"""

from __future__ import annotations

import asyncio
import zlib
from typing import Any, Dict, List, Optional

from .config import get_config
from .rpc import RemoteError, RpcClient, RpcError


def shard_index(key: str, num_shards: int) -> int:
    """Stable shard assignment for ``key`` over ``num_shards`` shards.

    crc32, not ``hash()``: str hashing is salted per process
    (PYTHONHASHSEED), and the assignment must agree across the client,
    the router proxy, and the shard that persisted the key in a previous
    incarnation."""
    if num_shards <= 1:
        return 0
    if isinstance(key, str):
        key = key.encode()
    return zlib.crc32(key) % num_shards


#: methods partitioned by an explicit key kwarg: method -> kwarg name.
#: KV shards by NAMESPACE (not key) so ``kv_keys(ns)`` stays a one-shard
#: read and a workflow's step commits land together.
KEYED_METHODS: Dict[str, str] = {
    "kv_put": "ns",
    "kv_get": "ns",
    "kv_multi_get": "ns",
    "kv_del": "ns",
    "kv_keys": "ns",
    "kv_exists": "ns",
}

#: append-only fan-in methods: any shard is correct (reads merge across
#: all shards at the router), so each WRITER sticks to the shard its own
#: identity hashes to — one process's event stream stays ordered on one
#: shard, and the cluster's writers spread over all of them.
FANIN_METHODS = frozenset({
    "add_task_events",
    "add_object_events",
    "add_sched_decisions",
})


def shard_for(method: str, kwargs: dict, identity: str,
              num_shards: int) -> Optional[int]:
    """-> owning shard index for one call, or None for router methods."""
    if num_shards <= 0:
        return None
    key_kwarg = KEYED_METHODS.get(method)
    if key_kwarg is not None:
        key = kwargs.get(key_kwarg)
        if key is None:
            return None
        return shard_index(str(key), num_shards)
    if method in FANIN_METHODS:
        return shard_index(identity, num_shards)
    return None


class ShardedGcsClient:
    """RpcClient-compatible facade over the router + its shard processes.

    ``connections`` (config ``gcs_client_connections``) opens that many
    parallel router connections, each on its own IO-loop lane; calls
    round-robin over them (mutating calls are already idempotency-token'd,
    and nothing the runtime sends the ROUTER is order-dependent across
    calls in flight — per-connection FIFO still holds for pubsub polls,
    which always ride connection 0).  Shard connections are one per shard,
    laned round-robin.
    """

    def __init__(self, address: str, connections: int | None = None,
                 identity: str = ""):
        self.address = address
        cfg = get_config()
        n = max(1, connections if connections is not None
                else cfg.gcs_client_connections)
        self._routers: List[RpcClient] = [
            RpcClient(address, lane=(0 if i == 0 else ("lane", i)))
            for i in range(n)]
        self._rr = 0
        self._identity = identity or "owner"
        self._shard_addrs: List[str] = []
        self._shard_clients: List[RpcClient] = []
        self._map_version = 0
        self._map_requested = False
        self._closed = False

    # -- shard map ---------------------------------------------------------

    @property
    def shard_map_version(self) -> int:
        return self._map_version

    def set_shard_map(self, addrs: List[str], version: int = 0):
        """Install the shard address list (from get_shard_map, or
        piggybacked on register_node/heartbeat).  Building the per-shard
        clients is cheap; connections open lazily on first use."""
        addrs = list(addrs or [])
        self._map_version = max(self._map_version, version)
        if addrs == self._shard_addrs:
            return
        old = self._shard_clients
        self._shard_addrs = addrs
        self._shard_clients = [
            RpcClient(a, lane=(0 if i == 0 else ("lane", i)))
            for i, a in enumerate(addrs)]
        for c in old:
            try:
                asyncio.ensure_future(c.close())
            except RuntimeError:
                pass

    def apply_shard_map(self, payload: Optional[dict]):
        """Install a {"version", "shards"} piggyback payload, if any."""
        if payload:
            self.set_shard_map(payload.get("shards") or [],
                               payload.get("version") or 0)

    def _maybe_fetch_map(self):
        """Kick ONE background shard-map fetch; until it lands calls go to
        the router (which proxies, so nothing is ever wrong — just one
        hop slower)."""
        if self._map_requested or self._closed:
            return
        self._map_requested = True

        async def _fetch():
            try:
                res = await self._routers[0].call(
                    "get_shard_map", _timeout=10)
                self.apply_shard_map(res)
            except Exception:
                self._map_requested = False  # retry on a later call

        try:
            asyncio.ensure_future(_fetch())
        except RuntimeError:
            self._map_requested = False

    # -- routing -----------------------------------------------------------

    def _router(self) -> RpcClient:
        self._rr += 1
        return self._routers[self._rr % len(self._routers)]

    def _client_for(self, method: str, kwargs: dict) -> RpcClient:
        shardable = method in FANIN_METHODS or method in KEYED_METHODS
        if not shardable:
            # globally-ordered router methods are LATENCY-sensitive
            # (lease/PG/actor chains await them serially): always the
            # first connection, which lives on the caller's own loop —
            # extra connections (their lane threads, their cross-thread
            # hops) carry only the bulk shardable traffic below
            return self._routers[0]
        if self._shard_clients:
            idx = shard_for(method, kwargs, self._identity,
                            len(self._shard_clients))
            if idx is not None:
                return self._shard_clients[idx]
            return self._routers[0]
        self._maybe_fetch_map()
        return self._router()

    def _shard_failed(self):
        """A shard connection died (shard restart under its supervisor):
        drop the map so the next calls refetch, and let THIS call fall
        back to the router — the router proxies to the live replacement,
        so shard churn costs a hop, never an error."""
        self._shard_addrs = []
        self._shard_clients = []
        self._map_requested = False

    # -- RpcClient-compatible surface -------------------------------------

    async def call(self, method: str, _timeout: float | None = None,
                   **kwargs) -> Any:
        client = self._client_for(method, kwargs)
        try:
            return await client.call(method, _timeout=_timeout, **kwargs)
        except (ConnectionError, OSError, RpcError,
                asyncio.TimeoutError) as e:
            # "was this a shard connection?" must not be answered by
            # membership in self._shard_clients: a CONCURRENT call that hit
            # the same dead shard may have run _shard_failed() first and
            # cleared/rebuilt the list, making the in-flight client look
            # foreign and re-raising instead of falling back.  Router
            # clients are the stable set — anything else is a shard.
            if client not in self._routers and not isinstance(
                    e, RemoteError):
                self._shard_failed()
                return await self._router().call(
                    method, _timeout=_timeout, **kwargs)
            raise

    async def call_retry(self, method: str, _timeout: float | None = None,
                         _attempts: int | None = None,
                         _idempotent: bool = True, **kwargs) -> Any:
        client = self._client_for(method, kwargs)
        try:
            return await client.call_retry(
                method, _timeout=_timeout, _attempts=_attempts,
                _idempotent=_idempotent, **kwargs)
        except (ConnectionError, OSError, RpcError, asyncio.TimeoutError) as e:
            # same membership race as call() above: router identity, not
            # _shard_clients membership, decides the fallback.
            if client not in self._routers and not isinstance(
                    e, RemoteError):
                self._shard_failed()
                return await self._router().call_retry(
                    method, _timeout=_timeout, _attempts=_attempts,
                    _idempotent=_idempotent, **kwargs)
            raise

    async def notify(self, method: str, **kwargs):
        return await self._client_for(method, kwargs).notify(method, **kwargs)

    def call_sync(self, method: str, _timeout: float | None = None,
                  **kwargs) -> Any:
        from .rpc import run_async
        return run_async(
            self.call(method, _timeout=_timeout, **kwargs),
            timeout=(_timeout or get_config().rpc_call_timeout_s) + 5)

    async def close(self):
        self._closed = True
        for c in self._routers + self._shard_clients:
            try:
                await c.close()
            except Exception:
                pass
