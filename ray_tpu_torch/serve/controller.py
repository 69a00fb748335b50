"""ServeController: the reconciliation control loop.

Reference: ``python/ray/serve/controller.py:82`` (ServeController actor) and
``_private/deployment_state.py:1156`` (DeploymentState replica state machine).
One detached named actor owns the desired state (deployments shipped by
``serve.run``) and continuously reconciles the live replica set against it:

* scale up: start replica actors until the target count of the target version
  is running;
* rolling update: when a deployment's code/config version changes, surge new
  replicas first, then drain+stop outdated ones once enough new ones are
  healthy (no request ever has zero healthy replicas to land on);
* health: periodic ``health_check`` pings per replica; 3 consecutive failures
  (or actor death) removes the replica, and the next reconcile pass replaces
  it;
* autoscaling: queue-depth driven (reference: _private/autoscaling_policy.py)
  — desired = ceil(total ongoing / target_ongoing_requests) clamped to
  [min, max], with upscale/downscale decision delays.

Routers and proxies pull the routing table with a version tag and long-poll
``wait_for_table_change`` (reference: _private/long_poll.py).
"""

from __future__ import annotations

import asyncio
import math
import time
import uuid
from typing import Any, Dict, List, Optional

from .config import (DEPLOYING, DELETING, HEALTHY, POLICY_SLO, UNHEALTHY,
                     UPDATING, DeploymentConfig)
from .deployment import Deployment
from .slo_autoscaler import (AutoscaleLedger, SLOPolicy,
                             capacity_max_replicas)

CONTROLLER_NAME = "serve:controller"

# replica lifecycle states (reference: _private/common.py ReplicaState)
STARTING = "STARTING"
RUNNING = "RUNNING"
DRAINING = "DRAINING"

HEALTH_FAILURE_THRESHOLD = 3


class _Replica:
    __slots__ = ("name", "handle", "version", "state", "failures",
                 "started_at", "last_ongoing", "code_hash", "last_probe",
                 "last_slo", "last_slo_ts", "last_prefix")

    def __init__(self, name: str, handle, version: str,
                 code_hash: Optional[str] = None):
        self.name = name
        self.handle = handle
        self.version = version
        self.state = STARTING
        self.failures = 0
        self.started_at = time.monotonic()
        self.last_ongoing = 0
        self.code_hash = code_hash
        self.last_probe = 0.0
        #: rolling SLO snapshot the replica piggybacks on health checks
        #: ({queue_depth, ttft_p50/p95/p99_ms, window_n} — serve/
        #: observability.slo_snapshot)
        self.last_slo: dict = {}
        #: monotonic stamp of the last SUCCESSFUL snapshot delivery — the
        #: staleness guard drops snapshots older than 3x the heartbeat
        #: period from the deployment rollup (a wedged replica's frozen
        #: p95 must not pollute the aggregate forever)
        self.last_slo_ts = 0.0
        #: prefix-cache digest piggybacked on the same heartbeat
        #: ({page, blocks: [hex block hashes]} — LLMServer.prefix_digest);
        #: None when the deployment doesn't expose one.  Shares
        #: last_slo_ts as its freshness stamp.
        self.last_prefix: Optional[dict] = None


class _DeploymentState:
    def __init__(self, deployment: Deployment):
        self.deployment = deployment
        self.version = deployment.version()
        self.app_blob = deployment.app_blob()
        self.replicas: List[_Replica] = []
        self.deleting = False
        # autoscale bookkeeping
        self.autoscale_target: Optional[int] = None
        self._scale_pending_since: Optional[float] = None
        self._scale_pending_dir = 0
        #: SLO-policy control state (serve/slo_autoscaler.SLOPolicy),
        #: created lazily on the first slo-policy reconcile tick and
        #: replaced when the deployment's autoscaling config changes
        self.slo_policy: Optional[SLOPolicy] = None
        self.last_decision: Optional[dict] = None

    @property
    def config(self) -> DeploymentConfig:
        return self.deployment.config

    def target_count(self) -> int:
        if self.deleting:
            return 0
        if self.config.autoscaling is not None:
            if self.autoscale_target is None:
                self.autoscale_target = self.config.initial_replicas()
            return self.autoscale_target
        return self.config.num_replicas

    def running(self, version: Optional[str] = None) -> List[_Replica]:
        return [r for r in self.replicas
                if r.state == RUNNING
                and (version is None or r.version == version)]

    def slo_rollup(self, now: Optional[float] = None) -> dict:
        """Deployment-level SLO signal from the replicas' heartbeat
        snapshots: total queue depth, and the WORST replica's rolling TTFT
        percentiles (the conservative scaling signal — one hot replica is
        exactly what an SLO autoscaler must react to).

        Staleness guard: snapshots older than 3x the heartbeat period are
        dropped from the rollup and counted as ``stale_replicas`` — a
        wedged replica's frozen p95 would otherwise pollute the aggregate
        (and hold the worst-replica percentile) forever.  The horizon
        never undercuts a legitimately slow ping: one probe is in flight
        per replica, so the worst honest gap between stamps is a full
        ``health_check_timeout_s`` plus a period — a busy-but-healthy
        replica must not be counted stale for a ping it is still allowed
        to be answering."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        horizon = now - max(3.0 * cfg.health_check_period_s,
                            cfg.health_check_timeout_s
                            + cfg.health_check_period_s)
        running = self.running()
        fresh = [r for r in running if r.last_slo_ts >= horizon]
        out = {
            "queue_depth": sum(
                int(r.last_slo.get("queue_depth", r.last_ongoing))
                for r in fresh),
            "window_n": sum(int(r.last_slo.get("window_n", 0))
                            for r in fresh),
            "stale_replicas": len(running) - len(fresh),
        }
        for p in ("p50", "p95", "p99"):
            key = f"ttft_{p}_ms"
            vals = [(r.last_slo[key], int(r.last_slo.get("window_n", 0)))
                    for r in fresh if key in r.last_slo]
            if vals:
                v, wn = max(vals)
                out[key] = v
                if p == "p95":
                    # the autoscaler's min_window_n gate must judge the
                    # WINDOW that produced the worst p95, not the
                    # deployment-wide sample sum — one replica's single
                    # slow request would otherwise read as a surge-worthy
                    # percentile backed by everyone else's samples
                    out["ttft_p95_window_n"] = wn
        return out

    def status(self) -> str:
        if self.deleting:
            return DELETING
        target = self.target_count()
        current = self.running(self.version)
        if len(current) >= target and all(
                r.version == self.version for r in self.replicas
                if r.state != DRAINING):
            return HEALTHY
        if any(r.version != self.version for r in self.replicas):
            return UPDATING
        if any(r.failures > 0 for r in self.replicas):
            return UNHEALTHY if not current else DEPLOYING
        return DEPLOYING


class ServeController:
    """The singleton control-loop actor (name: ``serve:controller``)."""

    def __init__(self, reconcile_period_s: float = 0.25):
        self.reconcile_period_s = reconcile_period_s
        self._deployments: Dict[str, _DeploymentState] = {}
        self._table_version = 0
        self._table_event: Optional[asyncio.Event] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._shutting_down = False
        self._http_config: Optional[dict] = None
        # strong refs to in-flight drain_then_kill tasks: keeps them alive,
        # and graceful_shutdown awaits them so detached replicas are never
        # orphaned past controller death
        self._drain_tasks: set = set()
        #: bounded ring of autoscale decision records (every scale event,
        #: incl. capacity-capped asks) + raytpu_autoscale_* metric stamps
        self._autoscale_ledger = AutoscaleLedger()
        #: one in-flight health ping per replica name (background tasks —
        #: a wedged ping must not stall the other replicas' heartbeats)
        self._probe_tasks: Dict[str, asyncio.Task] = {}
        # cluster-view cache for capacity-aware scale-up (refreshed at
        # most once a second — the reconcile loop must not hammer the GCS)
        self._capacity_view: Optional[dict] = None
        self._capacity_view_ts = 0.0

    # ------------------------------------------------------------ lifecycle

    async def startup(self) -> bool:
        """Idempotent: spawn the reconcile loop on the actor's event loop."""
        from . import observability as obs
        # a wedged reconcile loop surfaces as
        # raytpu_event_loop_lag_seconds{process="serve_controller"}
        obs.ensure_loop_monitor(self, "serve_controller")
        if self._loop_task is None or self._loop_task.done():
            self._table_event = asyncio.Event()
            self._loop_task = asyncio.get_event_loop().create_task(
                self._reconcile_loop())
        return True

    async def graceful_shutdown(self) -> bool:
        """Drain and stop every replica; used by serve.shutdown().  Blocks
        until every drain task finished — the caller kills this controller
        right after, and an unfinished background drain would orphan the
        detached replica actors."""
        self._shutting_down = True
        if self._loop_task is not None:
            self._loop_task.cancel()
        for t in list(self._probe_tasks.values()):
            t.cancel()
        self._probe_tasks.clear()
        for ds in self._deployments.values():
            for r in list(ds.replicas):
                await self._stop_replica(ds, r, graceful=True)
        if self._drain_tasks:
            await asyncio.gather(*list(self._drain_tasks),
                                 return_exceptions=True)
        for ds in self._deployments.values():
            ds.replicas.clear()
        self._deployments.clear()
        self._bump_table()
        return True

    # ------------------------------------------------------------- deploy

    async def deploy(self, deployment: Deployment) -> str:
        """Register/refresh a deployment; reconciliation does the rest.
        Returns the target version."""
        ds = self._deployments.get(deployment.name)
        if ds is None:
            self._deployments[deployment.name] = _DeploymentState(deployment)
        else:
            old_version = ds.version
            ds.deployment = deployment
            ds.version = deployment.version()
            ds.app_blob = deployment.app_blob()
            ds.deleting = False
            if old_version != ds.version:
                # user_config-only change: reconfigure in place, no restart
                if self._only_user_config_changed(ds, old_version):
                    await self._reconfigure_all(ds)
        return self._deployments[deployment.name].version

    def _only_user_config_changed(self, ds: _DeploymentState,
                                  old_version: str) -> bool:
        # Replicas of the old version whose code blob matches the new one can
        # be reconfigured in place (reference: deployment_state lightweight
        # config updates).  Compare code-only hash.
        import hashlib
        code_hash = hashlib.sha256(ds.app_blob).hexdigest()
        return bool(ds.replicas) and all(r.code_hash == code_hash
                                         for r in ds.replicas)

    async def _reconfigure_all(self, ds: _DeploymentState):
        cfg = ds.config
        for r in ds.replicas:
            try:
                await self._aget(r.handle.reconfigure.remote(cfg.user_config))
                r.version = ds.version
            except Exception:
                r.failures = HEALTH_FAILURE_THRESHOLD  # replace it

    async def delete_deployment(self, name: str) -> bool:
        ds = self._deployments.get(name)
        if ds is None:
            return False
        ds.deleting = True
        return True

    # ------------------------------------------------------- table queries

    def _bump_table(self):
        self._table_version += 1
        if self._table_event is not None:
            self._table_event.set()
            self._table_event = asyncio.Event()

    async def get_routing_table(self):
        """(version, {deployment -> [replica actor names]}) — RUNNING only."""
        table = {name: [r.name for r in ds.running()]
                 for name, ds in self._deployments.items() if not ds.deleting}
        return self._table_version, table

    async def get_routing_info(self):
        """(version, table, digests) — the routing table plus each running
        replica's last heartbeat prefix-cache digest, for cache-aware
        routing.  Digests ride the SAME freshness stamp as the SLO
        snapshot and share slo_rollup's staleness horizon: a wedged
        replica's frozen digest would otherwise keep attracting the
        prefixes it can no longer serve quickly.  Replicas without a
        digest (non-LLM deployments, prefix cache off) simply don't
        appear — the router falls back to pure p2c for them."""
        now = time.monotonic()
        table: Dict[str, List[str]] = {}
        digests: Dict[str, dict] = {}
        for name, ds in self._deployments.items():
            if ds.deleting:
                continue
            running = ds.running()
            table[name] = [r.name for r in running]
            cfg = ds.config
            horizon = now - max(3.0 * cfg.health_check_period_s,
                                cfg.health_check_timeout_s
                                + cfg.health_check_period_s)
            for r in running:
                if r.last_prefix and r.last_slo_ts >= horizon:
                    digests[r.name] = r.last_prefix
        return self._table_version, table, digests

    async def wait_for_table_change(self, known_version: int,
                                    timeout_s: float = 10.0):
        """Long-poll: return as soon as the table moves past known_version
        (reference: _private/long_poll.py LongPollHost)."""
        if self._table_version != known_version:
            return await self.get_routing_table()
        ev = self._table_event
        if ev is not None:
            try:
                await asyncio.wait_for(ev.wait(), timeout_s)
            except asyncio.TimeoutError:
                pass
        return await self.get_routing_table()

    async def get_http_routes(self):
        """{route_prefix -> deployment name} for the proxies."""
        routes = {}
        for name, ds in self._deployments.items():
            if ds.deleting:
                continue
            prefix = ds.config.route_prefix
            if prefix is None:
                prefix = f"/{name}"
            if prefix:
                routes[prefix] = name
        return self._table_version, routes

    async def get_status(self):
        out = {}
        for name, ds in self._deployments.items():
            out[name] = {
                "status": ds.status(),
                "version": ds.version,
                "target_replicas": ds.target_count(),
                "slo": ds.slo_rollup(),
                "replicas": [
                    {"name": r.name, "state": r.state, "version": r.version,
                     "ongoing": r.last_ongoing, "slo": r.last_slo}
                    for r in ds.replicas],
            }
            if ds.config.autoscaling is not None:
                out[name]["autoscale"] = {
                    "policy": ds.config.autoscaling.policy,
                    "target": ds.target_count(),
                    "min_replicas": ds.config.autoscaling.min_replicas,
                    "max_replicas": ds.config.autoscaling.max_replicas,
                    "last_decision": ds.last_decision,
                }
        return out

    async def get_autoscale_decisions(self, deployment: Optional[str] = None,
                                      limit: int = 50):
        """Tail of the bounded autoscale decision ring (newest last):
        every scale event — direction, reason, from/to replica counts,
        the signal snapshot it acted on, and capacity caps ("wanted N,
        cluster capped at M")."""
        return self._autoscale_ledger.tail(limit=limit,
                                           deployment=deployment)

    async def get_serve_signal(self):
        """The SLO autoscaler input contract, one row per deployment:
        ``{deployment: {queue_depth, ttft_p50_ms?, ttft_p95_ms?,
        ttft_p99_ms?, window_n, stale_replicas, running_replicas,
        target_replicas, ts}}``.  Queue depth is the live total across
        RUNNING replicas with a FRESH heartbeat snapshot (stale ones —
        older than 3x the heartbeat period — are dropped and counted in
        ``stale_replicas``); TTFT percentiles are the worst fresh
        replica's rolling window (absent until a replica has served a
        request inside the window).  Consumed by the SLO autoscaling
        policy (serve/slo_autoscaler.py), ``raytpu serve status``, and
        ``/api/serve`` dashboards."""
        now = time.time()
        out = {}
        for name, ds in self._deployments.items():
            if ds.deleting:
                continue
            out[name] = {
                **ds.slo_rollup(),
                "running_replicas": len(ds.running()),
                "target_replicas": ds.target_count(),
                "ts": now,
            }
            # declared SLO rides the signal so consumers (the health
            # plane's TTFT_BREACH rule, dashboards) can judge the
            # percentiles without digging into deployment config
            auto = ds.config.autoscaling
            if auto is not None and auto.ttft_p95_target_ms is not None:
                out[name]["ttft_p95_target_ms"] = auto.ttft_p95_target_ms
        return out

    async def set_http_config(self, config: dict):
        self._http_config = config
        return True

    async def get_http_config(self):
        return self._http_config

    # ------------------------------------------------- failure reporting

    async def report_replica_failure(self, deployment: str, replica: str):
        """Routers report dead replicas they hit; drop them immediately so the
        table converges faster than the next health-check period."""
        ds = self._deployments.get(deployment)
        if ds is None:
            return False
        for r in list(ds.replicas):
            if r.name == replica:
                ds.replicas.remove(r)
                t = self._probe_tasks.pop(r.name, None)
                if t is not None:
                    t.cancel()
                self._bump_table()
                await self._kill_replica(r)
                return True
        return False

    # --------------------------------------------------------- reconcile

    async def _reconcile_loop(self):
        while not self._shutting_down:
            try:
                changed = False
                for name in list(self._deployments):
                    ds = self._deployments[name]
                    changed |= await self._reconcile_one(ds)
                    if ds.deleting and not ds.replicas:
                        del self._deployments[name]
                        changed = True
                if changed:
                    self._bump_table()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                import traceback
                traceback.print_exc()
            await asyncio.sleep(self.reconcile_period_s)

    async def _reconcile_one(self, ds: _DeploymentState) -> bool:
        changed = await self._probe_health(ds)
        if ds.config.autoscaling is not None and not ds.deleting:
            if ds.config.autoscaling.policy == POLICY_SLO:
                await self._autoscale_slo(ds)
            else:
                self._autoscale(ds)
        target = ds.target_count()
        current = [r for r in ds.replicas if r.version == ds.version
                   and r.state in (STARTING, RUNNING)]
        outdated = [r for r in ds.replicas if r.version != ds.version
                    and r.state in (STARTING, RUNNING)]

        # Scale up new-version replicas toward the target.
        for _ in range(target - len(current)):
            self._start_replica(ds)
            changed = True

        # Rolling update: once enough new-version replicas serve traffic,
        # retire outdated ones (one batch per pass keeps it gradual).
        if outdated and len(ds.running(ds.version)) >= min(
                target, max(1, target - len(outdated) + 1)):
            victim = outdated[0]
            await self._stop_replica(ds, victim, graceful=True)
            changed = True

        # Scale down (autoscaling or lowered num_replicas / deletion):
        # drain-aware victim order — STARTING replicas first (nothing in
        # flight to drain), then the EMPTIEST running replica (fewest
        # ongoing requests = shortest graceful drain, newest breaks
        # ties); every victim rides the graceful path (stop accepting,
        # finish in-flight, then kill — never mid-request).
        excess = len(current) - target
        victims = sorted(
            current,
            key=lambda r: (0 if r.state == STARTING else 1,
                           int(r.last_slo.get("queue_depth", r.last_ongoing)),
                           -r.started_at))
        for r in victims[:max(0, excess)]:
            await self._stop_replica(ds, r, graceful=True)
            changed = True
        return changed

    async def _probe_health(self, ds: _DeploymentState) -> bool:
        """Ping replicas; promote STARTING->RUNNING, cull repeated failures.

        Pings run as INDEPENDENT background tasks (one in flight per
        replica), not a gathered pass: a dead replica's ping rides out the
        full health_check_timeout_s, and awaiting it inline would stall
        every healthy replica's heartbeat stamp behind it — exactly when a
        node dies mid-storm, the survivors' SLO snapshots would all go
        stale and the autoscaler would fly blind (observed in the storm
        bench before this went background)."""
        import ray_tpu_torch
        changed = False
        now = time.monotonic()
        # STARTING replicas are probed every pass (fast promotion); RUNNING
        # ones at the configured cadence — user check_health hooks can be
        # expensive (reference honors health_check_period_s the same way)
        due = [r for r in ds.replicas
               if (r.state == STARTING
                   or (r.state == RUNNING and now - r.last_probe
                       >= ds.config.health_check_period_s))
               and r.name not in self._probe_tasks]

        async def ping(r: _Replica):
            try:
                res = await asyncio.wait_for(
                    self._aget(r.handle.health_check.remote()),
                    ds.config.health_check_timeout_s)
                r.failures = 0
                r.last_ongoing = int(res.get("ongoing", 0))
                r.last_slo = res.get("slo") or {}
                r.last_slo_ts = time.monotonic()
                r.last_prefix = res.get("prefix")
                if r.state == STARTING:
                    r.state = RUNNING
                    self._bump_table()
            except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.WorkerCrashedError):
                r.failures = HEALTH_FAILURE_THRESHOLD  # dead: cull now
            except asyncio.CancelledError:
                raise
            except Exception:
                r.failures += 1
            finally:
                self._probe_tasks.pop(r.name, None)

        for r in due:
            r.last_probe = now
            self._probe_tasks[r.name] = \
                asyncio.get_event_loop().create_task(ping(r))
        for r in list(ds.replicas):
            if r.failures >= HEALTH_FAILURE_THRESHOLD:
                ds.replicas.remove(r)
                t = self._probe_tasks.pop(r.name, None)
                if t is not None:
                    t.cancel()
                await self._kill_replica(r)
                changed = True
        return changed

    # ------------------------------------------------------- autoscaling

    def _autoscale(self, ds: _DeploymentState):
        cfg = ds.config.autoscaling
        running = ds.running()
        if not running:
            # Scale-up-from-zero: an empty running set used to bail here,
            # so a deployment whose replicas all died (or whose
            # min_replicas floor was freshly breached) never recovered —
            # there is no ongoing-request signal without a replica to
            # carry it.  Treat zero running as desired=max(min_replicas,1)
            # immediately (no decision delay: waiting out a timer on a
            # dead deployment is deadlock-by-policy).
            desired = max(cfg.min_replicas, 1)
            if (ds.autoscale_target or 0) < desired:
                ds.autoscale_target = desired
                ds._scale_pending_since = None
                ds._scale_pending_dir = 0
            return
        total_ongoing = sum(r.last_ongoing for r in running)
        raw = total_ongoing / max(cfg.target_ongoing_requests, 1e-9)
        desired = math.ceil(raw * cfg.smoothing_factor)
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        current = ds.autoscale_target or len(running)
        if desired == current:
            ds._scale_pending_since = None
            ds._scale_pending_dir = 0
            return
        direction = 1 if desired > current else -1
        now = time.monotonic()
        if ds._scale_pending_dir != direction:
            ds._scale_pending_dir = direction
            ds._scale_pending_since = now
        delay = (cfg.upscale_delay_s if direction > 0
                 else cfg.downscale_delay_s)
        if now - (ds._scale_pending_since or now) >= delay:
            ds.autoscale_target = desired
            ds._scale_pending_since = None
            ds._scale_pending_dir = 0

    async def _autoscale_slo(self, ds: _DeploymentState):
        """One SLO-policy control tick: staleness-guarded signal in,
        (possibly) a new ``autoscale_target`` + a decision record out."""
        cfg = ds.config.autoscaling
        if ds.slo_policy is None or ds.slo_policy.cfg is not cfg:
            ds.slo_policy = SLOPolicy(cfg)
        signal = ds.slo_rollup()
        signal["running_replicas"] = len(ds.running())
        current = ds.target_count()
        # capacity-aware clamp: desired replicas the scheduler cannot
        # place would park STARTING forever while the record claims the
        # storm was handled — ask the cluster view what fits, and stamp
        # "wanted N, cluster capped at M" when it caps the ask
        alive = len([r for r in ds.replicas
                     if r.state in (STARTING, RUNNING)])
        cpus = float(ds.config.ray_actor_options.get("num_cpus", 1) or 1)
        cap = capacity_max_replicas(await self._cluster_view(), alive, cpus)
        dec = ds.slo_policy.decide(signal, current, time.monotonic(),
                                   capacity_max=cap)
        if dec is None:
            return
        last = ds.last_decision
        if (dec.desired == current and dec.capped and last is not None
                and last.get("capped")
                and last.get("to_replicas") == dec.desired
                and last.get("wanted") == dec.wanted
                and last.get("reason") == dec.reason):
            # an ONGOING identical capacity cap: one record per episode —
            # re-recording every delay period would flood the shared ring
            # and evict every other deployment's real scale history
            return
        ds.last_decision = self._autoscale_ledger.record(
            ds.deployment.name, dec, current, signal, cfg.policy)
        if dec.desired != current:
            ds.autoscale_target = dec.desired

    async def _cluster_view(self) -> Optional[dict]:
        """Cached GCS cluster view for capacity-aware scale-up (refreshed
        at most once a second; None — don't clamp — when unavailable)."""
        now = time.monotonic()
        if now - self._capacity_view_ts < 1.0:
            return self._capacity_view
        self._capacity_view_ts = now
        try:
            from ray_tpu_torch.core import rpc
            from ray_tpu_torch.core.core_worker import global_worker
            w = global_worker()
            fut = asyncio.run_coroutine_threadsafe(
                w.gcs.call("get_cluster_view"), rpc.get_loop())
            self._capacity_view = await asyncio.wait_for(
                asyncio.wrap_future(fut), 5.0)
        except Exception:  # view unavailable: scale decisions go unclamped
            self._capacity_view = None
        return self._capacity_view

    # ------------------------------------------------- replica start/stop

    def _start_replica(self, ds: _DeploymentState):
        import hashlib

        import ray_tpu_torch
        from .replica import ReplicaActor

        name = f"serve:{ds.deployment.name}:{uuid.uuid4().hex[:8]}"
        opts = dict(ds.config.ray_actor_options)
        opts.setdefault("num_cpus", 1)
        handle = ray_tpu_torch.remote(ReplicaActor).options(
            name=name, lifetime="detached",
            max_concurrency=ds.config.max_concurrent_queries, **opts,
        ).remote(ds.deployment.name, name, ds.app_blob,
                 ds.config.user_config)
        ds.replicas.append(_Replica(
            name, handle, ds.version,
            code_hash=hashlib.sha256(ds.app_blob).hexdigest()))

    async def _stop_replica(self, ds: _DeploymentState, r: _Replica,
                            graceful: bool):
        """Mark DRAINING (drops it from the routing table) and retire it.

        The graceful drain (wait for in-flight requests + unclaimed stream
        buffers) runs as a background task — awaiting it inline would stall
        the reconcile loop for every other deployment for up to
        graceful_shutdown_timeout_s per replica."""
        if r in ds.replicas:
            r.state = DRAINING
        self._bump_table()
        if not graceful:
            if r in ds.replicas:
                ds.replicas.remove(r)
            await self._kill_replica(r)
            return

        async def drain_then_kill():
            try:
                await asyncio.wait_for(
                    self._aget(r.handle.drain.remote(
                        ds.config.graceful_shutdown_timeout_s)),
                    ds.config.graceful_shutdown_timeout_s + 5)
            except Exception:
                pass
            if r in ds.replicas:
                ds.replicas.remove(r)
            await self._kill_replica(r)

        task = asyncio.get_event_loop().create_task(drain_then_kill())
        self._drain_tasks.add(task)
        task.add_done_callback(self._drain_tasks.discard)

    async def _kill_replica(self, r: _Replica):
        import ray_tpu_torch
        try:
            ray_tpu_torch.kill(r.handle)
        except Exception:
            pass

    # --------------------------------------------------------------- util

    @staticmethod
    async def _aget(ref):
        import ray_tpu_torch
        return await asyncio.wrap_future(ray_tpu_torch.as_future(ref))
