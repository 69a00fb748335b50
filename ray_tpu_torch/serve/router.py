"""Router + DeploymentHandle: replica selection and the calling surface.

Reference: ``python/ray/serve/_private/router.py:1191`` (Router),
``:328`` (PowerOfTwoChoicesReplicaScheduler), ``serve/handle.py:305``
(RayServeHandle).  Scheduling is power-of-two-choices over (local in-flight
count + last-known replica queue length): pick two random replicas, route to
the less loaded.  Replica death triggers local eviction + a routing-table
refresh; calls retry on another replica.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.common import (ActorDiedError, ActorUnavailableError,
                                 TaskError)

CONTROLLER_NAME = "serve:controller"


_DRAIN_REJECT = re.compile(r"^replica \S+ is draining$")


def is_retryable_failure(e: BaseException) -> bool:
    """A request may be transparently re-routed when the failure is about the
    *replica*, not the request: the replica died, became unreachable, or
    rejected the request because it is draining (rolling update / scale-down).

    Matching is deliberately narrow — application exceptions that merely
    *mention* draining or death must surface to the caller, not trigger a
    silent re-execution."""
    if isinstance(e, (ActorDiedError, ActorUnavailableError)):
        return True
    if isinstance(e, TaskError):
        cause = e.cause
        if isinstance(cause, (ActorDiedError, ActorUnavailableError)):
            return True
        # ReplicaActor's own drain rejection (replica.py raises exactly this)
        if isinstance(cause, RuntimeError) and _DRAIN_REJECT.match(str(cause)):
            return True
        # _strip_exc repackages unpicklable errors as
        # RuntimeError("<TypeName>: <msg>") — recognize repackaged death
        if isinstance(cause, RuntimeError) and str(cause).startswith(
                ("ActorDiedError:", "ActorUnavailableError:")):
            return True
    return False


def _controller():
    return ray_tpu_torch.get_actor(CONTROLLER_NAME)


def _block_hash(tokens: Sequence[int], page: int) -> str:
    """First-page block hash, truncated exactly as the replica digest is:
    MUST stay in lockstep with PrefixCache._hash (4-byte-LE token stream,
    16-byte blake2b) + first_page_digest's hex[:8] — a drift here silently
    turns every routing decision into a miss."""
    return hashlib.blake2b(
        b"".join(int(t).to_bytes(4, "little") for t in tokens[:page]),
        digest_size=16).digest().hex()[:8]


def _hint_tokens(args: tuple, kwargs: dict) -> Optional[list]:
    """Prompt tokens for cache-aware routing, when the payload looks like
    an LLM request ({"tokens": [...]} first arg, or a tokens= kwarg).
    Anything else — HTTP Request objects, non-LLM deployments — yields no
    hint and the router stays pure p2c."""
    cand = None
    if args and isinstance(args[0], dict):
        cand = args[0].get("tokens")
    if cand is None:
        cand = kwargs.get("tokens")
    if isinstance(cand, (list, tuple)) and cand \
            and all(isinstance(t, int) for t in cand[:4]):
        return list(cand)
    return None


class Router:
    """Caches the controller's routing table; assigns requests to replicas."""

    def __init__(self, refresh_interval_s: float = 0.5):
        self.refresh_interval_s = refresh_interval_s
        self._table: Dict[str, List[str]] = {}       # deployment -> replica names
        self._handles: Dict[str, Any] = {}           # replica name -> handle
        self._inflight: Dict[str, int] = {}          # replica name -> local count
        self._dep_inflight: Dict[str, int] = {}      # queue-depth gauge feed
        #: replica name -> (page_size, frozenset of first-page block
        #: hashes) from the controller's heartbeat-fed digest view; absent
        #: entries (non-LLM replicas, stale heartbeats, routing disabled)
        #: fall back to pure p2c
        self._digests: Dict[str, Tuple[int, frozenset]] = {}
        self._last_refresh = 0.0
        self._table_version = -1
        self._lock = threading.Lock()

    def _track(self, deployment: str, delta: int):
        from . import observability as obs
        if not obs.enabled():  # kill switch sheds the lock + bookkeeping too
            return
        # under _lock, including the gauge publish: increments come from N
        # client threads while decrements run in as_future done-callbacks —
        # an unlocked RMW would lose updates, and publishing outside the
        # lock could land a stale value last and pin the gauge there
        with self._lock:
            n = max(0, self._dep_inflight.get(deployment, 0) + delta)
            self._dep_inflight[deployment] = n
            obs.set_router_queue_depth(deployment, n)

    # ------------------------------------------------------------ table

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < self.refresh_interval_s:
            return
        ctrl = _controller()
        if self._prefix_routing_enabled():
            version, table, digests = ray_tpu_torch.get(
                ctrl.get_routing_info.remote(), timeout=30)
        else:
            version, table = ray_tpu_torch.get(
                ctrl.get_routing_table.remote(), timeout=30)
            digests = {}
        with self._lock:
            self._last_refresh = now
            # digests refresh every poll (they age independently of table
            # membership — a version check would freeze them)
            self._digests = {
                name: (int(d.get("page", 0)),
                       frozenset(d.get("blocks") or ()))
                for name, d in digests.items()
                if isinstance(d, dict) and d.get("page")}
            if version != self._table_version:
                self._table_version = version
                self._table = table
                live = {r for reps in table.values() for r in reps}
                self._handles = {k: v for k, v in self._handles.items()
                                 if k in live}

    @staticmethod
    def _prefix_routing_enabled() -> bool:
        from ray_tpu_torch.core.config import get_config
        return bool(getattr(get_config(), "serve_prefix_routing_enabled",
                            True))

    def _replica_handle(self, replica_name: str):
        h = self._handles.get(replica_name)
        if h is None:
            h = ray_tpu_torch.get_actor(replica_name)
            self._handles[replica_name] = h
        return h

    def _evict(self, deployment: str, replica_name: str):
        with self._lock:
            if replica_name in self._table.get(deployment, []):
                self._table[deployment].remove(replica_name)
            self._handles.pop(replica_name, None)

        def _report():
            try:
                _controller().report_replica_failure.remote(deployment,
                                                            replica_name)
            except Exception:
                pass

        # _evict also fires from ref done-callbacks, which run ON the IO
        # loop thread — get_actor's blocking GCS round-trip would raise in
        # run_async there (silently dropping the report).  Evictions are
        # rare; a short-lived thread keeps the report path thread-agnostic.
        if threading.current_thread().name == "raytpu-io":
            threading.Thread(target=_report, daemon=True,
                             name="router-evict-report").start()
        else:
            _report()

    # ------------------------------------------------------- p2c selection

    def choose_replica(self, deployment: str,
                       hint_tokens: Optional[Sequence[int]] = None) -> str:
        self._refresh()
        replicas = self._table.get(deployment)
        if not replicas:
            self._refresh(force=True)
            replicas = self._table.get(deployment)
            if not replicas:
                raise RuntimeError(f"no replicas for deployment "
                                   f"{deployment!r} (not deployed or scaled "
                                   f"to zero)")
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        la, lb = self._inflight.get(a, 0), self._inflight.get(b, 0)
        p2c = a if la <= lb else b
        if hint_tokens is None or not self._prefix_routing_enabled():
            return p2c
        return self._score_candidates(deployment, (a, la), (b, lb), p2c,
                                      hint_tokens)

    def _score_candidates(self, deployment: str, ca, cb, p2c: str,
                          hint_tokens: Sequence[int]) -> str:
        """Prefix-overlap x load scoring over the two p2c candidates:
        ``score = (inflight + 1) * (1 - weight * hit)`` where ``hit`` is
        membership of the request's first-page block hash in the
        candidate's heartbeat digest.  Absent digests on both candidates
        mean no signal — pure p2c, recorded as ``fallback``.  Ties keep
        the p2c pick so weight=0 degrades to exactly today's behavior."""
        from . import observability as obs
        from ray_tpu_torch.core.config import get_config
        (a, la), (b, lb) = ca, cb
        da, db = self._digests.get(a), self._digests.get(b)
        if da is None and db is None:
            obs.record_prefix_route(deployment, "fallback")
            return p2c
        w = min(1.0, max(0.0, float(getattr(
            get_config(), "serve_prefix_routing_weight", 0.5))))
        hashes: Dict[int, str] = {}  # page size -> request block hash

        def hit(load_digest) -> bool:
            if load_digest is None:
                return False
            page, blocks = load_digest
            if len(hint_tokens) < page:
                return False  # no full first page -> nothing reusable
            if page not in hashes:
                hashes[page] = _block_hash(hint_tokens, page)
            return hashes[page] in blocks
        ha, hb = hit(da), hit(db)
        sa = (la + 1) * (1.0 - w * ha)
        sb = (lb + 1) * (1.0 - w * hb)
        if sa == sb:
            chosen, was_hit = p2c, (ha if p2c == a else hb)
        elif sa < sb:
            chosen, was_hit = a, ha
        else:
            chosen, was_hit = b, hb
        obs.record_prefix_route(deployment, "hit" if was_hit else "miss")
        return chosen

    # ------------------------------------------------------------- calling

    def assign(self, deployment: str, args: tuple, kwargs: dict,
               method: Optional[str] = None):
        """Route one request; returns (replica_name, result ObjectRef).

        A replica whose name no longer resolves (actor died and was
        deregistered) is evicted and the request re-routed."""
        last_err: Optional[Exception] = None
        hint = _hint_tokens(args, kwargs)
        for _ in range(5):
            name = self.choose_replica(deployment, hint_tokens=hint)
            try:
                h = self._replica_handle(name)
                ref = h.handle_request.remote(args, kwargs, method)
            except Exception as e:  # noqa: BLE001 — dead name, submit fail
                last_err = e
                self._evict(deployment, name)
                continue
            self._inflight[name] = self._inflight.get(name, 0) + 1
            self._track(deployment, +1)
            self._attach_done(ref, deployment, name)
            return name, ref
        raise last_err or RuntimeError("routing failed")

    def _attach_done(self, ref, deployment: str, name: str):
        fut = ray_tpu_torch.as_future(ref)

        def _done(f):
            self._inflight[name] = max(0, self._inflight.get(name, 1) - 1)
            self._track(deployment, -1)
            exc = f.exception()
            if isinstance(exc, (ActorDiedError, ActorUnavailableError)):
                self._evict(deployment, name)

        fut.add_done_callback(_done)

    def start_stream(self, deployment: str, args: tuple, kwargs: dict,
                     method: Optional[str] = None) -> tuple:
        """Kick off a streaming request; returns (replica_name, stream_id,
        completion ref)."""
        last: Optional[Exception] = None
        hint = _hint_tokens(args, kwargs)
        for _ in range(5):
            name = self.choose_replica(deployment, hint_tokens=hint)
            stream_id = uuid.uuid4().hex
            try:
                h = self._replica_handle(name)
                ref = h.handle_request_streaming.remote(stream_id, args,
                                                        kwargs, method)
                # streams count toward p2c load + the queue-depth gauge
                # like unary calls — long-lived LLM streams are exactly
                # the traffic the SLO signal must see; the completion ref
                # resolves when the generator finishes, releasing both
                self._inflight[name] = self._inflight.get(name, 0) + 1
                self._track(deployment, +1)
                self._attach_done(ref, deployment, name)
                return name, stream_id, ref
            except Exception as e:  # noqa: BLE001
                last = e
                self._evict(deployment, name)
        raise last or RuntimeError("routing failed")


_router: Optional[Router] = None
_router_lock = threading.Lock()


def get_router() -> Router:
    global _router
    with _router_lock:
        if _router is None:
            _router = Router()
        return _router


def reset_router():
    global _router
    with _router_lock:
        _router = None


class DeploymentResponse:
    """The result of ``handle.remote(...)`` (reference: serve/handle.py
    DeploymentResponse).  Submission is eager; ``result()`` blocks and
    transparently re-routes to another replica if the assigned one died
    before/while executing (at-least-once on replica death)."""

    def __init__(self, deployment: str, args: tuple, kwargs: dict,
                 method: Optional[str]):
        self.deployment = deployment
        self._args = args
        self._kwargs = kwargs
        self._method = method
        self._replica, self._ref = get_router().assign(
            deployment, args, kwargs, method)

    def result(self, timeout_s: float = 60.0):
        deadline = time.monotonic() + timeout_s
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                return ray_tpu_torch.get(self._ref,
                                   timeout=max(0.1, deadline -
                                               time.monotonic()))
            except BaseException as e:  # noqa: BLE001
                if not is_retryable_failure(e):
                    raise
                last = e
                get_router()._evict(self.deployment, self._replica)
                self._replica, self._ref = get_router().assign(
                    self.deployment, self._args, self._kwargs, self._method)
        raise last or TimeoutError(
            f"no result from {self.deployment} in {timeout_s}s")

    async def result_async(self, timeout_s: float = 60.0):
        """Awaitable result() — for deployment-to-deployment calls inside
        async replica code (blocking would starve the replica's loop).
        Resolution is scheduled on the worker's RPC loop via ``as_future``
        (the replica's actor loop must not touch loop-bound RPC state)."""
        import asyncio
        deadline = time.monotonic() + timeout_s
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                fut = ray_tpu_torch.as_future(self._ref)
                return await asyncio.wait_for(
                    asyncio.wrap_future(fut),
                    max(0.1, deadline - time.monotonic()))
            except BaseException as e:  # noqa: BLE001
                if not is_retryable_failure(e):
                    raise
                last = e
                get_router()._evict(self.deployment, self._replica)
                self._replica, self._ref = get_router().assign(
                    self.deployment, self._args, self._kwargs, self._method)
        raise last or TimeoutError(
            f"no result from {self.deployment} in {timeout_s}s")

    def _to_object_ref(self):
        """The underlying ObjectRef (no retry semantics)."""
        return self._ref


class DeploymentHandle:
    """Calling surface for a deployment (reference: serve/handle.py:305).

    ``h.remote(...)`` returns a DeploymentResponse (``.result()`` it);
    ``h.method.remote(...)`` routes to a named method;
    ``h.stream(...)`` yields chunks from a generator endpoint.
    """

    def __init__(self, deployment: str, method: Optional[str] = None):
        self.deployment = deployment
        self.method = method

    def __getattr__(self, item: str) -> "DeploymentHandle":
        if item.startswith("_"):
            raise AttributeError(item)
        return DeploymentHandle(self.deployment, item)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return DeploymentResponse(self.deployment, args, kwargs, self.method)

    def stream(self, *args, timeout_s: Optional[float] = None, **kwargs):
        """Synchronous chunk iterator over a streaming endpoint.

        ``timeout_s`` bounds the WHOLE stream: a replica that stops
        yielding without erroring (wedged engine, lost stream buffer)
        would otherwise pin the consumer in the next_chunks long-poll
        forever — open-loop load harnesses pass this so one wedged
        request cannot hang a whole benchmark run."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        router = get_router()
        name, stream_id, ref = router.start_stream(self.deployment, args,
                                                   kwargs, self.method)
        h = router._replica_handle(name)
        cursor, done = 0, False
        while not done:
            poll_timeout = 60.0
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # abandon server-side too: an unclaimed buffer would
                    # block the replica's graceful drain forever
                    try:
                        h.cancel_stream.remote(stream_id)
                    except Exception:
                        pass
                    raise TimeoutError(f"stream from {self.deployment!r} "
                                       f"exceeded {timeout_s}s")
                poll_timeout = min(poll_timeout, remaining + 1.0)
            try:
                chunks, cursor, done = ray_tpu_torch.get(
                    h.next_chunks.remote(stream_id, cursor),
                    timeout=poll_timeout)
            except Exception:
                # a WEDGED replica never returns the long-poll at all —
                # the bounded get converts that into the same abandon
                # path instead of overshooting the budget by 60s
                if deadline is not None and time.monotonic() >= deadline:
                    try:
                        h.cancel_stream.remote(stream_id)
                    except Exception:
                        pass
                    raise TimeoutError(
                        f"stream from {self.deployment!r} exceeded "
                        f"{timeout_s}s") from None
                raise
            yield from chunks
        # surface errors from the generator body
        ray_tpu_torch.get(ref, timeout=60)

    async def stream_async(self, *args, **kwargs):
        router = get_router()
        name, stream_id, ref = router.start_stream(self.deployment, args,
                                                   kwargs, self.method)
        h = router._replica_handle(name)
        cursor, done = 0, False
        while not done:
            chunks, cursor, done = await asyncio.wrap_future(
                ray_tpu_torch.as_future(h.next_chunks.remote(stream_id, cursor)))
            for c in chunks:
                yield c
        await asyncio.wrap_future(ray_tpu_torch.as_future(ref))
