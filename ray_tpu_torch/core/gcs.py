"""GCS-equivalent cluster control plane.

One per cluster, like the reference's GCS server (``src/ray/gcs/gcs_server/gcs_server.h:79``,
subsystems initialized at :120-177).  Owns:

* **Node table + health checks** — agents register and heartbeat; missed heartbeats past
  the failure threshold mark the node dead and publish it (reference:
  ``GcsNodeManager`` + ``GcsHealthCheckManager``).
* **Internal KV** — namespaced key/value store; also backs the function registry
  (reference: ``GcsKvManager`` / ``function_manager.py`` shipping pickled defs via KV).
* **Actor manager** — registration, placement via a node agent lease, restart-on-failure
  up to ``max_restarts``, named/detached actors (reference: ``GcsActorManager``
  ``gcs_actor_manager.cc:246,632`` + ``GcsActorScheduler``).
* **Placement groups** — 2-phase prepare/commit bundle reservation across agents
  (reference: ``GcsPlacementGroupScheduler``, ``node_manager.proto:388-395``).
* **Pubsub** — long-lived subscriber connections receive one-way pushes per topic
  (reference: ``src/ray/pubsub/``).
* **Resource view broadcast** — aggregates agent heartbeats into the cluster view that
  drives client-side scheduling (reference: RaySyncer gossip, ``ray_syncer.h:86``).
* **Job table** and a bounded **task-event buffer** for the state API (reference:
  ``GcsJobManager`` / ``GcsTaskManager``).

State is optionally snapshotted to disk so a restarted GCS can recover cluster metadata
(reference: Redis-backed ``gcs_table_storage.cc``).
"""

from __future__ import annotations

import asyncio
import bisect
import os
import pickle
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import sched_explain
from .common import TaskSpec
from .config import get_config
from .ids import ActorID, JobID, NodeID, PlacementGroupID
from .rpc import ClientPool, RpcServer
from .sched_explain import PendingReason
from .scheduling import NodeView, pack_bundles, pick_node
from .sharded_table import SecondaryIndex, ShardedTable


class GcsServer:
    """The control-plane ROUTER: owns everything that needs global
    ordering (node table, jobs, actor registration + scheduling, PG 2PC,
    pubsub seq space) and fronts the optional GCS shard processes
    (``gcs_shard_processes > 0``, core/gcs_shard.py) that serve the hot
    key-partitionable traffic.  With shards enabled, shard-routable
    handlers here PROXY to the owning shard — so legacy clients keep
    working — while shard-aware clients (core/gcs_router.ShardedGcsClient)
    go client->shard direct by key."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persistence_path: Optional[str] = None,
                 session_dir: Optional[str] = None):
        self.server = RpcServer(self, host, port)
        cfg = get_config()
        self.session_dir = session_dir
        # shard-process plane (started in start() when configured)
        self._shard_procs: List = []          # Popen per shard index
        self._shard_addrs: List[str] = []
        self._shard_clients: List = []        # RpcClient per shard index
        self._shard_map_version = 0
        self.nodes: Dict[str, NodeView] = {}
        self.node_last_seen: Dict[str, float] = {}
        # Pubsub: PER-TOPIC seq-ordered logs (a poll for topic T touches
        # only T's log, cursor-indexed by bisect — never a scan of every
        # topic's traffic), fanned out once per loop tick (_fanout_tick).
        self._topic_logs: Dict[str, List[Tuple[int, dict]]] = {}
        self._event_seq = 0
        # parked pubsub polls: event -> the topic set it waits on.  Fanout
        # is TOPIC-AWARE: a tick's publishes wake only the subscribers of
        # the touched topics — waking every parked poll on every publish
        # made each control-plane transition (PG create, actor state) cost
        # an extra poll round trip per unrelated subscriber.
        self._event_waiters: Dict[asyncio.Event, frozenset] = {}
        self._fanout_topics: set = set()
        self._fanout_scheduled = False
        # Hot tables are hash-sharded (bounded rehash pauses, per-shard
        # iteration) with O(1)-maintained reverse indexes replacing every
        # failure-path full-table scan (see core/sharded_table.py).
        shards = max(1, cfg.gcs_table_shards)
        self.kv: ShardedTable = ShardedTable(shards)  # (ns, key) -> bytes
        self._kv_ns_index = SecondaryIndex()          # ns -> {key}
        self.actors: ShardedTable = ShardedTable(shards)  # actor hex -> info
        self._actors_by_node = SecondaryIndex()       # node_id -> {actor hex}
        self._live_actors_by_job = SecondaryIndex()   # job hex -> {actor hex}
        self.named_actors: Dict[Tuple[str, str], str] = {}  # (ns, name) -> actor id hex
        self.pgs: Dict[str, dict] = {}
        self._pg_events: Dict[str, asyncio.Event] = {}
        self.jobs: Dict[str, dict] = {}
        self.agent_clients = ClientPool()
        self.task_events: deque = deque(maxlen=cfg.task_events_max_buffer)
        #: events owners shed at their bounded buffers (observability)
        self.task_events_dropped = 0
        #: latest submission-plane counter snapshot per owner (piggybacks
        #: the task-event flush; sched_stats rolls these up)
        self.submit_plane_counters: Dict[str, dict] = {}
        # Scheduler explain plane: bounded ring of structured decision
        # records (pick_node/pack_bundles outcomes with per-node rejection
        # causes) from this GCS's own scheduling loops AND from owners
        # (add_sched_decisions piggybacks their task-event flush); plus
        # per-handler cumulative busy seconds when sched metrics are on.
        self.sched_decisions: deque = deque(
            maxlen=max(64, cfg.sched_decision_ring_len))
        # Object-plane flight recorder: bounded age-out ring of object
        # lifecycle transition events (CREATED/SEALED/SPILLED/RESTORED/
        # TRANSFERRED/RE_HOMED/FREED) flushed by node agents and owners —
        # the ``state.explain_object`` / ``raytpu explain <oid>`` backing
        # store (the sched_decision ring pattern on the data plane).
        self.object_events: deque = deque(
            maxlen=max(64, cfg.object_event_ring_len))
        self.object_events_dropped = 0
        # Health plane (util/health.py): bounded age-out ring of alert
        # transition events (raised/cleared) — the sched_decision ring
        # pattern applied to health.  The GCS evaluates its two
        # process-local rules at health-check cadence; the dashboard
        # head flushes its rule subset here so ``state.health()`` /
        # ``raytpu doctor`` see ONE trail regardless of who detected.
        self.health_alerts: deque = deque(
            maxlen=max(16, cfg.health_ring_len))
        self._health_detector = None
        self._health_prev: Dict[str, object] = {}
        #: latest active-alert list per external detector ("head"), with
        #: its push timestamp — stale pushes age out of handle_health
        self._health_active_ext: Dict[str, dict] = {}
        self._handler_busy: Dict[str, float] = {}
        self._handler_calls: Dict[str, int] = {}
        self._gcs_hist_keys: Dict[str, tuple] = {}  # precomputed tag keys
        # Runtime chaos control (core/chaos.py): the cluster-wide spec and
        # its version; agents learn of changes via heartbeat piggyback
        # (and anyone else via the "chaos" pubsub topic).
        self._chaos_spec: Optional[dict] = None
        self._chaos_version = 0
        # Elastic train plane: active drain notices (node agents report at
        # drain START, seconds before the node dies — the advance warning
        # elastic trainers resize on) and the bounded completed-resize
        # ring + in-progress map the doctor/state surfaces read back.
        self._drain_notices: Dict[str, dict] = {}
        self._train_resizes: deque = deque(maxlen=256)
        self._train_resizing: Dict[str, dict] = {}
        # Dead lease-owner broadcast: worker addresses whose process is
        # confirmed gone (actor killed/crashed, node died under it).  Agents
        # pick these up on heartbeat and reclaim any task-worker lease that
        # owner still holds — without this an orphaned lease pins CPUs until
        # the pin sweep's 3-strike liveness probe (~30s), which stalls an
        # elastic re-form racing the reclamation for the freed slot.
        self._dead_owner_seq = 0
        self._dead_owners: deque = deque(maxlen=256)
        self._job_counter = 0
        self._bg: List[asyncio.Task] = []
        self.persistence_path = persistence_path
        self._persist_scheduled = False  # coalesces _persist_soon per tick
        self._started_at = time.time()

    # ------------------------------------------------------------------ boot

    async def start(self):
        self._maybe_restore()
        if sched_explain.enabled():
            # per-handler busy attribution (synchronous-segment thread-CPU
            # time; see rpc._BusyTimed) — the "what is the control plane
            # spending its time on" half of the explain plane
            self.server.busy_cb = self._on_handler_busy
        await self.server.start()
        await self._start_shards()
        self._restart_pending_pgs()
        self._restart_pending_actors()
        self._bg.append(asyncio.ensure_future(self._health_check_loop()))

        async def _self_call(method, **kw):
            # the GCS writes its own distress events straight into its KV
            return await getattr(self, f"handle_{method}")(**kw)

        from ray_tpu_torch.util.loop_monitor import install as _install_loop_mon
        self._loop_monitor = _install_loop_mon(
            asyncio.get_event_loop(), "gcs", gcs_call=_self_call)
        return self

    @property
    def address(self) -> str:
        return self.server.address

    async def stop(self):
        if getattr(self, "_loop_monitor", None):
            self._loop_monitor.stop()
        for t in self._bg:
            t.cancel()
        for c in self._shard_clients:
            try:
                await c.close()
            except Exception:
                pass
        for proc in self._shard_procs:
            try:
                proc.terminate()
            except Exception:
                pass

        def _reap(procs=list(self._shard_procs)):
            # blocking waits belong OFF the loop: a shard wedged in a
            # synchronous snapshot write must not freeze every other
            # coroutine here for its grace period
            for proc in procs:
                try:
                    proc.wait(timeout=5)
                except Exception:
                    try:
                        proc.kill()
                    except Exception:
                        pass

        if self._shard_procs:
            await asyncio.get_event_loop().run_in_executor(None, _reap)
        await self.agent_clients.close_all()
        await self.server.stop()

    # ------------------------------------------------------- shard processes

    @property
    def num_shards(self) -> int:
        return len(self._shard_addrs)

    async def _start_shards(self):
        n = get_config().gcs_shard_processes
        if n <= 0:
            return
        from .gcs_shard import spawn_shard_processes
        from .rpc import RpcClient
        # Shards ALWAYS get a snapshot file when any directory exists to
        # put one in: a supervised shard respawn must restore its slice of
        # the KV (function registry, workflow commits) even when the
        # router itself runs without persistence — a single-process GCS
        # only loses its KV by dying wholesale, and sharding must not
        # weaken that.
        self._shard_persist_base = self.persistence_path or (
            os.path.join(self.session_dir, "gcs.snap")
            if self.session_dir else None)
        # subprocess spawn + the stdout handshake block; keep the loop live
        spawned = await asyncio.get_event_loop().run_in_executor(
            None, spawn_shard_processes, n, self._shard_persist_base,
            self.session_dir)
        self._shard_procs = [p for p, _a in spawned]
        self._shard_addrs = [a for _p, a in spawned]
        self._shard_clients = [RpcClient(a) for a in self._shard_addrs]
        self._shard_map_version += 1
        self._bg.append(asyncio.ensure_future(self._shard_watch_loop()))

    async def _shard_watch_loop(self):
        """Shard supervision: a dead shard process is respawned at the
        same index, restoring from its own snapshot file — the router is
        the shard fleet's supervisor the way an agent supervises its
        workers.  Clients holding the stale address fail fast with
        ConnectionLost and fall back to the router proxy until they
        refresh the map (heartbeat piggyback / get_shard_map)."""
        from .gcs_shard import spawn_shard_processes
        from .rpc import RpcClient
        while True:
            await asyncio.sleep(0.5)
            for i, proc in enumerate(self._shard_procs):
                if proc.poll() is None:
                    continue
                try:
                    spawned = await asyncio.get_event_loop().run_in_executor(
                        None, spawn_shard_processes,
                        len(self._shard_procs), self._shard_persist_base,
                        self.session_dir, i)
                except Exception:
                    continue
                (newproc, addr), = spawned
                try:
                    await self._shard_clients[i].close()
                except Exception:
                    pass
                self._shard_procs[i] = newproc
                self._shard_addrs[i] = addr
                self._shard_clients[i] = RpcClient(addr)
                self._shard_map_version += 1
                self._publish("gcs_shards",
                              {"version": self._shard_map_version,
                               "shards": list(self._shard_addrs)})

    async def handle_get_shard_map(self):
        """Shard address list for shard-aware clients (gcs_router
        facade).  Empty when sharding is off — the facade then routes
        everything here."""
        return {"version": self._shard_map_version,
                "shards": list(self._shard_addrs)}

    def _shard_client_for(self, key: str):
        """Proxy-side shard pick — THE partition helper, same as clients."""
        from .gcs_router import shard_index
        return self._shard_clients[shard_index(key, len(self._shard_clients))]

    async def _shard_call(self, shard_key: str, method: str,
                          _idempotent: bool = True, **kwargs):
        """Proxy one call to the shard owning ``shard_key``, riding
        through a shard-process restart: transport failures re-resolve
        the CURRENT client (the supervisor swaps in the replacement's
        address) and retry until the standard call deadline — a shard
        respawn costs proxied callers latency, never an error."""
        from .rpc import RemoteError, RpcError
        deadline = time.monotonic() + get_config().rpc_call_timeout_s
        while True:
            client = self._shard_client_for(shard_key)
            try:
                return await client.call_retry(
                    method, _idempotent=_idempotent,
                    _timeout=max(1.0, deadline - time.monotonic()), **kwargs)
            except RemoteError:
                raise  # application error from the shard handler
            except (ConnectionError, OSError, RpcError,
                    asyncio.TimeoutError):
                if time.monotonic() >= deadline:
                    raise
                await asyncio.sleep(0.1)

    async def _shard_call_all(self, method: str, **kwargs) -> List:
        """Fan one read out to every shard; unreachable shards contribute
        nothing (their supervisor is already respawning them)."""
        if not self._shard_clients:
            return []

        async def _one(c):
            try:
                return await c.call(method, _timeout=10, **kwargs)
            except Exception:
                return None

        return [r for r in await asyncio.gather(
            *[_one(c) for c in self._shard_clients]) if r is not None]

    # ------------------------------------------------------------- persistence

    def _maybe_restore(self):
        p = self.persistence_path
        if p and os.path.exists(p):
            with open(p, "rb") as f:
                snap = pickle.load(f)
            # Sharded tables restore entry-by-entry (the snapshot stores
            # plain dicts, not shard layouts, so gcs_table_shards may
            # change between incarnations) and their secondary indexes are
            # REBUILT from the restored rows — the indexes are derived
            # state, never independently authoritative.
            for k, v in snap.get("kv", {}).items():
                self.kv[k] = v
                self._kv_ns_index.add(k[0], k[1])
            self.jobs = snap.get("jobs", {})
            self.named_actors = snap.get("named_actors", {})
            for aid, info in snap.get("actors", {}).items():
                self.actors[aid] = info
                self._index_actor(aid, info)
            self._job_counter = snap.get("job_counter", 0)
            # pubsub topic logs + global seq: subscriber cursors from the
            # previous incarnation stay valid (a poll after restart picks
            # up exactly where it left off instead of replaying or
            # skipping the world)
            self._topic_logs = {t: [tuple(e) for e in log] for t, log in
                                snap.get("topic_logs", {}).items()}
            self._event_seq = snap.get("event_seq", 0)
            # placement groups: CREATED placements restore as-is (their
            # nodes re-register); PENDING ones get their scheduler kicked
            # again once the loop runs
            self.pgs = snap.get("pgs", {})
            self._chaos_spec = snap.get("chaos_spec")
            self._chaos_version = snap.get("chaos_version", 0)
            for pg_id, info in self.pgs.items():
                self._pg_events[pg_id] = asyncio.Event()
                if info.get("state") in ("CREATED", "INFEASIBLE", "REMOVED"):
                    self._pg_events[pg_id].set()

    def _restart_pending_pgs(self):
        for pg_id, info in self.pgs.items():
            if info.get("state") == "PENDING":
                asyncio.ensure_future(self._schedule_pg(pg_id))

    def _restart_pending_actors(self):
        """Re-kick scheduling for actors snapshotted mid-placement: the
        in-flight _schedule_actor task died with the previous process, and
        nothing else ever unsticks a PENDING/RESTARTING actor (the
        report_actor_death path early-returns on RESTARTING)."""
        for aid, info in list(self.actors.items()):
            if (info.get("state") in ("PENDING", "RESTARTING")
                    and info.get("spec") is not None):
                asyncio.ensure_future(self._schedule_actor(aid))

    def _persist_soon(self):
        """Coalesced snapshot write: transitions that are NOT a durability
        contract (actor/PG state — recoverable from re-registration and
        owner retries) schedule ONE full-state write per loop tick instead
        of pickling the whole GCS per event.  A 1000-actor wave costs one
        snapshot, not 2-3 per actor.  KV/job writes stay synchronous: a
        workflow step's commit must be on disk before its kv_put acks."""
        if not self.persistence_path or self._persist_scheduled:
            return
        self._persist_scheduled = True

        def _flush():
            self._persist_scheduled = False
            self._persist()

        try:
            asyncio.get_running_loop().call_soon(_flush)
        except RuntimeError:
            _flush()  # no loop (unit tests): write inline

    def _persist(self):
        p = self.persistence_path
        if not p:
            return
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"kv": self.kv.to_dict(), "jobs": self.jobs,
                         "named_actors": self.named_actors,
                         "actors": self.actors.to_dict(),
                         "job_counter": self._job_counter,
                         "pgs": self.pgs,
                         "topic_logs": self._topic_logs,
                         "event_seq": self._event_seq,
                         "chaos_spec": self._chaos_spec,
                         "chaos_version": self._chaos_version}, f)
        os.replace(tmp, p)

    # ------------------------------------------------------- actor indexes

    def _index_actor(self, aid: str, info: dict):
        """(Re)derive one actor's index membership from its info dict —
        used on restore; live transitions maintain the indexes in place."""
        if info.get("state") == "DEAD":
            return
        self._actors_by_node.add(info.get("node_id"), aid)
        self._live_actors_by_job.add(info.get("job_id"), aid)

    def _actor_placed(self, aid: str, info: dict, node_id: str):
        self._actors_by_node.move(info.get("node_id"), node_id, aid)

    def _actor_unplaced(self, aid: str, info: dict):
        self._actors_by_node.discard(info.get("node_id"), aid)

    def _actor_dead(self, aid: str, info: dict):
        self._actors_by_node.discard(info.get("node_id"), aid)
        self._live_actors_by_job.discard(info.get("job_id"), aid)

    def _note_dead_owner(self, addr: Optional[str]):
        """Record a confirmed-dead worker address for heartbeat broadcast
        (see _dead_owners above).  seq-tagged so each agent only replays
        entries it has not seen; the deque bound means an agent that falls
        >256 entries behind misses some — the pin sweep backstops those."""
        if not addr:
            return
        self._dead_owner_seq += 1
        self._dead_owners.append((self._dead_owner_seq, addr))

    # ---------------------------------------------------------------- pubsub
    #
    # Long-poll pubsub (reference: GCS pubsub long-polling,
    # ``core_worker.proto:436-441``): subscribers call ``pubsub_poll`` with a
    # cursor; the call parks until an event past the cursor arrives for one of
    # the requested topics.

    def _publish(self, topic: str, payload: dict):
        self._event_seq += 1
        log = self._topic_logs.setdefault(topic, [])
        log.append((self._event_seq, payload))
        cap = max(100, get_config().gcs_pubsub_topic_log_len)
        if len(log) > cap:
            # trim front half: cursors are global seqs, so a subscriber
            # that fell further behind simply misses the trimmed window
            # (same contract the old global ring had)
            del log[:len(log) // 2]
        # Fanout is BATCHED per loop tick: a burst of N publishes in one
        # tick (an actor wave, a node death cascade) wakes each parked
        # subscriber once, not N times — wake cost is O(subscribers) per
        # tick instead of O(subscribers x publishes).
        self._fanout_topics.add(topic)
        if not self._fanout_scheduled:
            self._fanout_scheduled = True
            try:
                # get_running_loop (not get_event_loop): with no RUNNING
                # loop the latter hands back a fresh dead loop on 3.10,
                # the callback never fires, and the latched flag would
                # suppress every future wakeup
                asyncio.get_running_loop().call_soon(self._fanout_tick)
            except RuntimeError:
                self._fanout_tick()  # no loop (unit tests): wake inline

    def _fanout_tick(self):
        self._fanout_scheduled = False
        touched = self._fanout_topics
        self._fanout_topics = set()
        for ev, topics in self._event_waiters.items():
            if not topics.isdisjoint(touched):
                ev.set()

    async def handle_publish(self, topic: str, payload: dict):
        """Generic topic publish (reference: src/ray/pubsub Publisher) — used
        by the log monitor, available to any client."""
        self._publish(topic, payload)
        return self._event_seq

    async def handle_pubsub_poll(self, topics: List[str], cursor: int,
                                 timeout: float = 30.0):
        def pending():
            # Cursor-indexed per-topic reads: bisect each requested topic's
            # log past the cursor and merge by seq — cost is O(new events
            # for THESE topics), flat in total cluster traffic.
            out: List[Tuple[int, str, dict]] = []
            for t in topics:
                log = self._topic_logs.get(t)
                if not log:
                    continue
                i = bisect.bisect_right(log, cursor, key=lambda e: e[0])
                out.extend((seq, t, p) for seq, p in log[i:])
            out.sort(key=lambda e: e[0])
            return out

        got = pending()
        if got:
            return self._event_seq, got
        ev = asyncio.Event()
        self._event_waiters[ev] = frozenset(topics)
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            self._event_waiters.pop(ev, None)
        return self._event_seq, pending()

    # ---------------------------------------------------------------- chaos
    #
    # Runtime control of the fault-injection plane (core/chaos.py).  A
    # chaos_set installs the spec in THIS process, bumps the version, and
    # broadcasts on the "chaos" pubsub topic; agents additionally converge
    # via heartbeat piggyback (handle_heartbeat) and forward to their
    # workers — so one call degrades every link in the cluster.

    async def handle_chaos_set(self, spec: dict | str | None):
        from . import chaos as _chaos
        if isinstance(spec, str):
            import json as _json
            spec = _json.loads(spec) if spec.strip() else {}
        self._chaos_version += 1
        self._chaos_spec = spec or None
        _chaos.install(spec)
        self._publish("chaos", {"version": self._chaos_version,
                                "spec": self._chaos_spec})
        return self._chaos_version

    async def handle_chaos_clear(self):
        return await self.handle_chaos_set(None)

    async def handle_chaos_get(self):
        from . import chaos as _chaos
        inj = _chaos.injector()
        return {"version": self._chaos_version, "spec": self._chaos_spec,
                "injected": inj.injected_counts() if inj else {}}

    # ---------------------------------------------------------------- nodes

    async def handle_register_node(self, node_id: str, address: str,
                                   resources: Dict[str, float],
                                   labels: Dict[str, str]):
        self.nodes[node_id] = NodeView(node_id, address, dict(resources),
                                       dict(resources), labels, True, 0)
        self.node_last_seen[node_id] = time.monotonic()
        self._publish("nodes", {"event": "alive", "node_id": node_id, "address": address})
        return {"node_id": node_id, "cluster_view": self._view_payload(),
                "shard_map": {"version": self._shard_map_version,
                              "shards": list(self._shard_addrs)},
                # the dead-owner broadcast seq is in-memory: after a GCS
                # restart it re-counts from 0, below any seq the agents
                # remember, and the `seq < ours` heartbeat check would
                # silently skip every new broadcast until it caught up.
                # Re-registration (the unknown-node heartbeat path) is
                # exactly when an agent meets a restarted GCS — hand it
                # the current seq so it resyncs instead of comparing
                # against a counter from a previous incarnation.
                "dead_owners_seq": self._dead_owner_seq}

    async def handle_update_node_resources(self, node_id: str,
                                           total: Dict[str, float],
                                           available: Dict[str, float]):
        """A node's resource CAPACITY changed at runtime (reference:
        experimental/dynamic_resources.py -> NodeManager resource-set
        path): refresh the view totals so the scheduler and autoscaler
        see the new shape immediately instead of at the next heartbeat."""
        n = self.nodes.get(node_id)
        if n is None:
            return {"unknown": True}
        n.total = dict(total)
        n.available = dict(available)
        self._publish("nodes", {"event": "resources", "node_id": node_id,
                                "total": n.total})
        return {"ok": True}

    async def handle_heartbeat(self, node_id: str, available: Dict[str, float],
                               queue_len: int = 0, store_stats: dict | None = None,
                               queued_demands: List[Dict[str, float]] | None = None,
                               total: Dict[str, float] | None = None,
                               chaos_version: int | None = None,
                               draining: bool = False,
                               shard_map_version: int | None = None,
                               dead_owners_seq: int | None = None,
                               task_leased: Dict[str, float] | None = None):
        n = self.nodes.get(node_id)
        if n is None:
            return {"unknown": True}  # agent should re-register
        n.available = dict(available)
        # short-lived task-lease usage: elastic sizing treats it as
        # reclaimable headroom (the leases idle-return within seconds once
        # their submitter stops), unlike actor/bundle holds
        n.task_leased = dict(task_leased or {})
        if total is not None:
            n.total = dict(total)
        n.queue_len = queue_len
        if bool(draining) != n.draining:
            n.draining = bool(draining)
            if n.draining:
                # broadcast the notice: schedulers route around the node
                # while it finishes leases and re-homes its objects
                self._publish("nodes", {"event": "draining",
                                        "node_id": node_id})
        # resource shapes queued behind this node's leases — the autoscaler's
        # scale-up signal (reference: cluster load reported to the monitor,
        # autoscaler/_private/load_metrics.py)
        n.labels["_queued_demands"] = queued_demands or []
        if not n.alive:
            n.alive = True
            self._publish("nodes", {"event": "alive", "node_id": node_id,
                                    "address": n.address})
        if store_stats:
            n.labels["_store"] = store_stats
        self.node_last_seen[node_id] = time.monotonic()
        res = {"view": self._view_payload()}
        if chaos_version is not None and chaos_version != self._chaos_version:
            # piggyback the runtime chaos spec on the reply so agents that
            # missed the pubsub broadcast (or restarted) converge anyway
            res["chaos"] = {"version": self._chaos_version,
                            "spec": self._chaos_spec}
        if (shard_map_version is not None
                and shard_map_version != self._shard_map_version):
            # same convergence pattern for the shard map: a respawned
            # shard's new address reaches every agent within a heartbeat
            res["shard_map"] = {"version": self._shard_map_version,
                                "shards": list(self._shard_addrs)}
        if (dead_owners_seq is not None
                and dead_owners_seq < self._dead_owner_seq):
            # confirmed-dead lease owners this agent has not yet replayed:
            # it reclaims their leased task workers on receipt (the ~30s
            # pin-sweep probe remains the backstop for owners the GCS
            # never tracked, e.g. a SIGKILLed driver)
            res["dead_owners"] = {
                "seq": self._dead_owner_seq,
                "addrs": [a for s, a in self._dead_owners
                          if s > dead_owners_seq]}
        return res

    async def handle_drain_node(self, node_id: str):
        await self._mark_node_dead(node_id, reason="drained")
        return True

    async def handle_report_drain_notice(self, node_id: str,
                                         notice_s: float = 0.0):
        """A node agent received a preemption notice and started draining
        — recorded at drain START so elastic trainers (and the doctor)
        see the warning while the notice window is still open, not after
        the node is gone.  Also flips the node's draining flag
        immediately: waiting one heartbeat to route schedulers around a
        dying node wastes notice budget."""
        now = time.time()
        self._drain_notices[node_id] = {
            "node_id": node_id, "notice_s": float(notice_s),
            "reported_at": now, "deadline": now + max(0.0, float(notice_s)),
        }
        n = self.nodes.get(node_id)
        if n is not None and not n.draining:
            n.draining = True
            self._publish("nodes", {"event": "draining",
                                    "node_id": node_id})
        return True

    async def handle_get_drain_notices(self):
        """Active + recently-completed drain notices.  ``active`` means
        the node is still alive (draining); a notice lingers ~60s past
        its node's death so doctor/timeline surfaces can attribute the
        death to the drain, then ages out."""
        now = time.time()
        out = []
        for nid, rec in list(self._drain_notices.items()):
            n = self.nodes.get(nid)
            alive = bool(n is not None and n.alive)
            if now - rec["deadline"] > 60.0:
                if not alive:
                    self._drain_notices.pop(nid, None)
                    continue
                if n is not None and not n.draining:
                    # drain aborted (preemption cancelled): the node
                    # outlived its deadline by the full grace window and
                    # cleared its draining flag — without this the notice
                    # stays active forever and doctor shows a phantom
                    # "draining ... expires in 0s" for a healthy node
                    self._drain_notices.pop(nid, None)
                    continue
            out.append({**rec, "active": alive,
                        "remaining_s": max(0.0, rec["deadline"] - now)})
        return out

    async def handle_train_resize_started(self, trial: str, record: dict):
        self._train_resizing[trial or "train"] = {
            **(record or {}), "ts": time.time()}
        return True

    async def handle_add_train_resize(self, record: dict):
        """One completed elastic resize (direction/from/to/wall_s/...) —
        appended to the bounded ring behind ``raytpu train`` / doctor."""
        trial = (record or {}).get("trial") or "train"
        self._train_resizing.pop(trial, None)
        self._train_resizes.append(dict(record or {}))
        self._publish("train", {"event": "resize", **(record or {})})
        return True

    async def handle_get_train_resizes(self, limit: int = 100):
        # an in-progress entry older than 5 min is a dead driver, not a
        # resize — age it out rather than alarming forever
        now = time.time()
        for t, rec in list(self._train_resizing.items()):
            if now - rec.get("ts", now) > 300.0:
                self._train_resizing.pop(t, None)
        return {"records": list(self._train_resizes)[-max(1, int(limit)):],
                "in_progress": dict(self._train_resizing)}

    async def handle_report_pending_demand(self, reporter: str, shape: dict,
                                           count: int = 1):
        """Drivers/workers report demand shapes no live node can satisfy
        (infeasible-task load; reference: load_metrics resource demand).
        Entries expire after a few seconds of silence."""
        if not hasattr(self, "_pending_demands"):
            self._pending_demands = {}
        key = (reporter, tuple(sorted(shape.items())))
        self._pending_demands[key] = (dict(shape), count, time.monotonic())
        return True

    async def handle_get_load(self):
        """Cluster load for the autoscaler: per-node resources + pending
        demand shapes + infeasible driver demands (reference: the monitor's
        GetAllResourceUsage poll)."""
        now = time.monotonic()
        pending = []
        for key, (shape, count, ts) in list(
                getattr(self, "_pending_demands", {}).items()):
            if now - ts > 5.0:
                self._pending_demands.pop(key, None)
                continue
            pending.extend([shape] * count)
        return {
            "nodes": {
                nid: {
                    "alive": n.alive,
                    # a draining node's free capacity is a mirage — the
                    # autoscaler must not let it absorb simulated demand
                    # (its replacement IS the demand)
                    "draining": n.draining,
                    "total": n.total,
                    "available": n.available,
                    "queue_len": n.queue_len,
                    "queued_demands": n.labels.get("_queued_demands", []),
                    "labels": {k: v for k, v in n.labels.items()
                               if not k.startswith("_")},
                }
                for nid, n in self.nodes.items()},
            "pending_demands": pending,
        }

    def _view_payload(self) -> Dict[str, dict]:
        return {nid: {"address": n.address, "total": n.total,
                      "available": n.available, "labels": {k: v for k, v in n.labels.items()
                                                           if not k.startswith("_")},
                      "alive": n.alive, "queue_len": n.queue_len,
                      "draining": n.draining, "task_leased": n.task_leased}
                for nid, n in self.nodes.items()}

    async def handle_get_cluster_view(self):
        return self._view_payload()

    async def _health_check_loop(self):
        cfg = get_config()
        while True:
            await asyncio.sleep(cfg.health_check_period_s)
            now = time.monotonic()
            deadline = cfg.health_check_period_s * cfg.health_check_failure_threshold
            for nid, n in list(self.nodes.items()):
                if n.alive and now - self.node_last_seen.get(nid, now) > deadline:
                    await self._mark_node_dead(nid, reason="heartbeat timeout")
            try:
                self._health_tick()
            except Exception:
                pass  # the detector must never take down liveness checks

    def _health_tick(self):
        """GCS-side health rules (EVENTS_SHED, GCS_HANDLER_HOT) over
        process-local counters this object already maintains — dict
        walks at health-check cadence, no RPCs, no per-task work.  With
        the kill switch off this is ONE boolean check."""
        from ray_tpu_torch.util import health as health_plane
        if not health_plane.enabled():
            self._health_detector = None  # next enable starts clean
            return
        now = time.time()
        det = self._health_detector
        if det is None:
            # first enabled tick: baseline the cumulative counters so
            # pre-existing sheds don't fire a stale alert
            self._health_detector = health_plane.gcs_detector()
            self._health_prev = {"ts": now,
                                 "shed": self.task_events_dropped,
                                 "busy": dict(self._handler_busy)}
            return
        prev = self._health_prev
        dt = max(1e-9, now - float(prev.get("ts", now)))
        shed_delta = self.task_events_dropped - int(prev.get("shed", 0))
        prev_busy = prev.get("busy") or {}
        busy_frac = {}
        for method, busy in self._handler_busy.items():
            d = busy - prev_busy.get(method, 0.0)
            if d > 0:
                busy_frac[method] = d / dt
        self._health_prev = {"ts": now, "shed": self.task_events_dropped,
                             "busy": dict(self._handler_busy)}
        snap = {"now": now, "events_shed": max(0, shed_delta),
                "events_shed_total": self.task_events_dropped,
                "handler_busy": busy_frac,
                # elastic evidence: nodes draining under an active notice
                # and trains mid-resize — NODE_DRAINING / TRAIN_RESIZING
                # fire from here so an operator can tell planned churn
                # from flapping
                "draining_notices": {
                    nid: max(0.0, rec["deadline"] - time.time())
                    for nid, rec in self._drain_notices.items()
                    if (self.nodes.get(nid) is not None
                        and self.nodes[nid].alive)},
                "train_resizing": {
                    t: {"direction": rec.get("direction"),
                        "from": rec.get("from")}
                    for t, rec in self._train_resizing.items()}}
        events = det.observe(snap, now)
        health_plane.record_transitions(events, det)
        if events:
            self._prune_health_alerts()
            self.health_alerts.extend(events)

    async def _mark_node_dead(self, node_id: str, reason: str):
        n = self.nodes.get(node_id)
        if n is None or not n.alive:
            return
        n.alive = False
        self._publish("nodes", {"event": "dead", "node_id": node_id, "reason": reason})
        # Restart or fail actors that lived there (reference:
        # GcsActorManager::OnNodeDead) — via the by-node index, so a node
        # death touches only ITS actors, not the whole table.
        for aid in self._actors_by_node.get(node_id):
            info = self.actors.get(aid)
            if info is not None and info["state"] in ("ALIVE", "PENDING"):
                await self._on_actor_failure(aid, f"node {node_id[:12]} died: {reason}")

    # ------------------------------------------------------------------- KV

    # With shard processes enabled, the KV lives IN the shards (by
    # namespace); these handlers become the compat PROXY for clients that
    # don't hold the shard map — shard-aware clients skip the hop.

    async def handle_kv_put(self, ns: str, key: str, value: bytes,
                            overwrite: bool = True):
        if self._shard_clients:
            return await self._shard_call(
                ns, "kv_put", ns=ns, key=key, value=value,
                overwrite=overwrite)
        k = (ns, key)
        if not overwrite and k in self.kv:
            return False
        self.kv[k] = value
        self._kv_ns_index.add(ns, key)
        self._persist()
        return True

    async def handle_kv_get(self, ns: str, key: str):
        if self._shard_clients:
            return await self._shard_call(ns, "kv_get", ns=ns, key=key,
                                          _idempotent=False)
        return self.kv.get((ns, key))

    async def handle_kv_multi_get(self, ns: str, keys: List[str]):
        if self._shard_clients:
            return await self._shard_call(ns, "kv_multi_get", ns=ns,
                                          keys=keys, _idempotent=False)
        return {k: self.kv[(ns, k)] for k in keys if (ns, k) in self.kv}

    async def handle_kv_del(self, ns: str, key: str):
        if self._shard_clients:
            return await self._shard_call(ns, "kv_del", ns=ns, key=key)
        existed = self.kv.pop((ns, key), None) is not None
        if existed:
            self._kv_ns_index.discard(ns, key)
            self._persist()
        return existed

    async def handle_kv_keys(self, ns: str, prefix: str = ""):
        if self._shard_clients:
            return await self._shard_call(ns, "kv_keys", ns=ns, prefix=prefix,
                                          _idempotent=False)
        # per-namespace index: listing one ns never scans the others
        return [k for k in self._kv_ns_index.get(ns) if k.startswith(prefix)]

    async def handle_kv_exists(self, ns: str, key: str):
        if self._shard_clients:
            return await self._shard_call(ns, "kv_exists", ns=ns, key=key,
                                          _idempotent=False)
        return (ns, key) in self.kv

    # ---------------------------------------------------------------- actors

    async def handle_register_actor(self, spec: TaskSpec,
                                    get_if_exists: bool = False):
        """Register (or, with get_if_exists, atomically adopt) an actor.

        The GCS is the single serialization point for names: concurrent
        get-or-create callers race HERE, not at a client-side pre-check, so
        the loser receives the winner's actor id (reference:
        GcsActorManager name-conflict handling for get_if_exists)."""
        aid = spec.actor_id.hex()
        if spec.actor_name:
            key = (spec.namespace or "default", spec.actor_name)
            if key in self.named_actors:
                existing = self.named_actors[key]
                if self.actors.get(existing, {}).get("state") != "DEAD":
                    if get_if_exists:
                        return existing
                    raise ValueError(f"actor name {spec.actor_name!r} already taken")
            self.named_actors[key] = aid
        self.actors[aid] = {
            "actor_id": aid, "state": "PENDING", "spec": spec, "address": None,
            "node_id": None, "restarts_left": spec.max_restarts, "name": spec.actor_name,
            "namespace": spec.namespace or "default", "owner": spec.owner,
            "death_cause": None, "num_restarts": 0, "class_name": spec.name,
            "lifetime": spec.lifetime, "job_id": spec.job_id.hex(),
        }
        self._live_actors_by_job.add(spec.job_id.hex(), aid)
        self._persist_soon()
        asyncio.ensure_future(self._schedule_actor(aid))
        return aid

    async def _schedule_actor(self, aid: str, delay: float = 0.0):
        if delay:
            await asyncio.sleep(delay)
        info = self.actors.get(aid)
        if info is None or info["state"] == "DEAD":
            return
        spec: TaskSpec = info["spec"]
        pg_pending = False
        last_reason = None
        for attempt in range(120):
            # Re-check each attempt: a kill while PENDING/RESTARTING must not be
            # overwritten back to ALIVE by a late placement success.
            if self.actors.get(aid) is not info or info["state"] == "DEAD":
                return
            strategy = spec.scheduling_strategy
            pg_pending = False
            if (isinstance(strategy, tuple) and strategy
                    and strategy[0] == "_pg"):
                # PG-placed actor: the creation MUST go to the node holding
                # its bundle — pick_node knows nothing about the resolved
                # ("_pg", pg_id, idx, node_id) tuple and used to fall
                # through to the DEFAULT policy, sending create_actor to an
                # arbitrary node whose agent then raised "unknown placement
                # bundle" (placement succeeded only by retry luck).  The
                # PG table's CURRENT placement wins over the node recorded
                # at submission (a rescheduled PG may have moved).
                from .scheduling import NodeAffinitySchedulingStrategy
                _tag, pg_id, idx, nid_hint = strategy
                pg = self.pgs.get(pg_id)
                target = None
                placement = (pg or {}).get("placement")
                if placement and 0 <= idx < len(placement):
                    target = placement[idx][0]
                # a missing/uncreated placement means the actor is blocked
                # behind its placement group, not behind resources
                pg_pending = target is None and (
                    pg is None or pg.get("state") != "CREATED")
                strategy = NodeAffinitySchedulingStrategy(
                    target or nid_hint, soft=False)
            explain: Dict[str, object] = {}
            nid = pick_node(self.nodes, spec.resources, strategy,
                            explain=explain)
            if nid is None:
                reason = (PendingReason.PG_PENDING if pg_pending
                          else sched_explain.reason_for_no_node(explain))
                if info.get("pending_reason") != reason:
                    info["pending_reason"] = reason
                    info["reason_since"] = time.time()
                # decision records are rate-limited to transitions + a
                # periodic heartbeat: a stuck actor's 120-attempt loop
                # must not flood the ring with identical records
                if reason != last_reason or attempt % 20 == 0:
                    last_reason = reason
                    self._record_decision({
                        "kind": "actor", "id": aid,
                        "label": info.get("class_name"),
                        "demand": dict(spec.resources or {}),
                        "outcome": "no_node", "reason": reason,
                        "candidates": explain.get("candidates"),
                        **sched_explain.bound_rejected(
                            explain.get("rejected")),
                        "attempt": attempt})
            if nid is not None:
                agent = self.agent_clients.get(self.nodes[nid].address)
                try:
                    # Idempotent retry: a creation whose REPLY was lost must
                    # hand back the same worker on retry, not lease a second
                    # one (the agent's dedup window holds the grant).
                    res = await agent.call_retry(
                        "create_actor", spec=spec,
                        _timeout=get_config().actor_creation_timeout_s + 30)
                    if self.actors.get(aid) is not info or info["state"] == "DEAD":
                        # Killed while the creation RPC was in flight: reap the
                        # freshly created worker instead of resurrecting.
                        try:
                            await agent.call_retry(
                                "kill_worker", worker_id=res["worker_id"],
                                reason="actor killed during creation")
                        except Exception:
                            pass
                        return
                    self._actor_placed(aid, info, nid)
                    info.pop("pending_reason", None)
                    info.pop("reason_since", None)
                    info.update(state="ALIVE", address=res["worker_address"],
                                node_id=nid, worker_id=res["worker_id"])
                    if last_reason is not None or attempt > 0:
                        # close a previously-stuck trail; happy-path
                        # placements stay out of the ring (actor churn
                        # would evict the records worth keeping)
                        self._record_decision({
                            "kind": "actor", "id": aid,
                            "label": info.get("class_name"),
                            "outcome": "placed", "node": nid,
                            "attempt": attempt})
                    self._persist_soon()
                    self._publish("actors", {"actor_id": aid, "state": "ALIVE",
                                             "address": res["worker_address"]})
                    return
                except Exception as e:  # noqa: BLE001 — placement failure, retry
                    info["last_error"] = repr(e)
            await asyncio.sleep(0.25)
        await self._fail_actor(aid, f"could not place actor: {info.get('last_error')}")

    async def _on_actor_failure(self, aid: str, reason: str):
        info = self.actors.get(aid)
        # RESTARTING guard: the worker-death report that follows a deliberate
        # restart-kill must not burn a second restart.
        if info is None or info["state"] in ("DEAD", "RESTARTING"):
            return
        if info["restarts_left"] != 0:
            if info["restarts_left"] > 0:
                info["restarts_left"] -= 1
            info["num_restarts"] += 1
            self._actor_unplaced(aid, info)
            # the pre-restart incarnation's process is gone: any task-worker
            # lease it still owns is orphaned — broadcast before the address
            # is cleared for the new placement
            self._note_dead_owner(info.get("address"))
            info.update(state="RESTARTING", address=None, node_id=None)
            self._publish("actors", {"actor_id": aid, "state": "RESTARTING"})
            asyncio.ensure_future(self._schedule_actor(aid, delay=0.1))
        else:
            await self._fail_actor(aid, reason)

    async def _fail_actor(self, aid: str, reason: str):
        info = self.actors.get(aid)
        if info is None:
            return
        self._actor_dead(aid, info)
        self._note_dead_owner(info.get("address"))
        info.update(state="DEAD", death_cause=reason)
        self._persist_soon()
        self._publish("actors", {"actor_id": aid, "state": "DEAD", "reason": reason})

    async def handle_report_actor_death(self, actor_id: str, reason: str,
                                        expected: bool = False):
        if expected:
            await self._fail_actor(actor_id, reason)
        else:
            await self._on_actor_failure(actor_id, reason)
        return True

    async def handle_list_named_actors(self, namespace: str = "default",
                                       all_namespaces: bool = False):
        """Live named actors (reference: ``GcsActorManager::ListNamedActors``
        behind ``ray.util.list_named_actors``)."""
        out = []
        for (ns, name), aid in self.named_actors.items():
            info = self.actors.get(aid)
            if info is None or info.get("state") == "DEAD":
                continue
            if all_namespaces or ns == namespace:
                out.append({"namespace": ns, "name": name})
        return out

    async def handle_get_actor_info(self, actor_id: Optional[str] = None,
                                    name: Optional[str] = None,
                                    namespace: str = "default"):
        if actor_id is None:
            actor_id = self.named_actors.get((namespace, name))
            if actor_id is None:
                return None
        info = self.actors.get(actor_id)
        if info is None:
            return None
        return {k: v for k, v in info.items() if k != "spec"}

    async def handle_wait_actor_alive(self, actor_id: str, timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = self.actors.get(actor_id)
            if info is None:
                return None
            if info["state"] == "ALIVE":
                return {k: v for k, v in info.items() if k != "spec"}
            if info["state"] == "DEAD":
                return {k: v for k, v in info.items() if k != "spec"}
            await asyncio.sleep(0.02)
        return {"state": "TIMEOUT", "actor_id": actor_id}

    async def handle_kill_actor(self, actor_id: str, no_restart: bool = True):
        info = self.actors.get(actor_id)
        if info is None:
            return False
        if no_restart:
            info["restarts_left"] = 0
        addr = info.get("address")
        nid = info.get("node_id")
        if addr and nid and nid in self.nodes:
            agent = self.agent_clients.get(self.nodes[nid].address)
            try:
                await agent.call_retry("kill_worker",
                                       worker_id=info.get("worker_id"),
                                       reason="ray.kill")
            except Exception:
                pass
        if no_restart:
            await self._fail_actor(actor_id, "killed via ray.kill")
        else:
            # Restartable kill: treat like a crash so max_restarts applies
            # (reference: GcsActorManager::DestroyActor vs restart path).
            await self._on_actor_failure(actor_id, "killed via ray.kill(no_restart=False)")
        return True

    async def handle_list_actors(self):
        return [{k: v for k, v in info.items() if k != "spec"}
                for info in self.actors.values()]

    # ---------------------------------------------------------- placement groups

    async def handle_create_placement_group(self, pg_id: str,
                                            bundles: List[Dict[str, float]],
                                            strategy: str, name: str = "",
                                            lifetime: Optional[str] = None):
        self.pgs[pg_id] = {"pg_id": pg_id, "bundles": bundles, "strategy": strategy,
                           "state": "PENDING", "name": name, "placement": None,
                           "lifetime": lifetime, "created_at": time.time()}
        self._pg_events[pg_id] = asyncio.Event()
        self._persist_soon()
        asyncio.ensure_future(self._schedule_pg(pg_id))
        # common case on an uncontended cluster: the placement settles
        # within one agent round trip — piggyback the result on the create
        # reply so the client's ready() needs no second RPC.  Only wait
        # when a placement is packable RIGHT NOW; a pending-forever PG
        # must not add latency to batch creates (the long-poll
        # wait_placement_group remains the general path).
        if pack_bundles(self.nodes, bundles, strategy) is not None:
            ev = self._pg_events.get(pg_id)
            try:
                await asyncio.wait_for(ev.wait(), 0.25)
            except asyncio.TimeoutError:
                pass
        info = self.pgs.get(pg_id)
        return {"pg_id": pg_id,
                "info": info if info and info["state"] != "PENDING" else None}

    def _pg_settled(self, pg_id: str):
        ev = self._pg_events.get(pg_id)
        if ev is not None:
            ev.set()

    async def _schedule_pg(self, pg_id: str):
        info = self.pgs.get(pg_id)
        if info is None:
            return
        last_reason = None
        for attempt in range(200):
            explain: Dict[str, object] = {}
            placement = pack_bundles(self.nodes, info["bundles"],
                                     info["strategy"], explain=explain)
            if placement is None:
                reason = sched_explain.reason_for_no_node(explain)
                if info.get("pending_reason") != reason:
                    info["pending_reason"] = reason
                    info["reason_since"] = time.time()
                if reason != last_reason or attempt % 25 == 0:
                    last_reason = reason
                    self._record_decision({
                        "kind": "pg", "id": pg_id,
                        "label": info.get("name") or pg_id[:12],
                        "demand": list(info["bundles"]),
                        "strategy": info["strategy"],
                        "outcome": "no_placement", "reason": reason,
                        "candidates": explain.get("candidates"),
                        **sched_explain.bound_rejected(
                            explain.get("rejected")),
                        "attempt": attempt})
            if placement is not None:
                # 2-phase prepare/commit (reference PrepareBundleResources/
                # CommitBundleResources), batched to ONE RPC per node per
                # phase; a placement that lands entirely on one node takes
                # the fused prepare_commit path — no cross-node atomicity
                # to coordinate, so one round trip creates the whole PG.
                by_node: Dict[str, Dict[int, dict]] = {}
                for i, nid in enumerate(placement):
                    by_node.setdefault(nid, {})[i] = info["bundles"][i]

                async def _phase(method: str, nid: str, payload) -> bool:
                    agent = self.agent_clients.get(self.nodes[nid].address)
                    try:
                        # retried prepares/commits carry an idempotency
                        # token: a lost reply must not double-reserve
                        return bool(await agent.call_retry(
                            method, pg_id=pg_id, **payload))
                    except Exception:
                        return False

                if len(by_node) == 1:
                    nid, bundles = next(iter(by_node.items()))
                    ok = await _phase("prepare_commit_bundles", nid,
                                      {"bundles": bundles})
                    results = {nid: ok}
                else:
                    results = dict(zip(by_node, await asyncio.gather(
                        *[_phase("prepare_bundles", nid, {"bundles": b})
                          for nid, b in by_node.items()])))
                    if all(results.values()):
                        # a failed COMMIT must also fail the attempt — a
                        # PG published CREATED with an uncommitted bundle
                        # breaks every lease against it
                        commits = await asyncio.gather(
                            *[_phase("commit_bundles", nid,
                                     {"indices": list(b)})
                              for nid, b in by_node.items()])
                        for nid, ok in zip(by_node, commits):
                            results[nid] = results[nid] and ok
                if all(results.values()):
                    info.pop("pending_reason", None)
                    info.pop("reason_since", None)
                    if last_reason is not None:
                        self._record_decision({
                            "kind": "pg", "id": pg_id,
                            "label": info.get("name") or pg_id[:12],
                            "outcome": "placed",
                            "nodes": list(dict.fromkeys(placement)),
                            "attempt": attempt})
                    info.update(state="CREATED",
                                placement=[(nid, self.nodes[nid].address)
                                           for nid in placement])
                    self._persist_soon()
                    self._pg_settled(pg_id)
                    self._publish("pgs", {"pg_id": pg_id, "state": "CREATED"})
                    return
                # Roll back on EVERY node of the attempt, including ones
                # whose prepare/commit RPC failed — a lost reply may have
                # applied server-side, and return_bundles is idempotent
                # (pops whatever exists), so over-returning is safe while
                # under-returning leaks the bundle until agent restart.
                await asyncio.gather(
                    *[_phase("return_bundles", nid, {"indices": list(b)})
                      for nid, b in by_node.items()])
            if self.pgs.get(pg_id) is None:
                return
            # quick first retries (a bundle freed a moment ago — e.g. an
            # async PG removal still returning resources), then back off
            await asyncio.sleep(min(0.02 * (2 ** min(attempt, 4)), 0.25))
        info["state"] = "INFEASIBLE"
        self._pg_settled(pg_id)

    async def handle_get_placement_group(self, pg_id: str):
        return self.pgs.get(pg_id)

    async def handle_wait_placement_group(self, pg_id: str, timeout: float = 60.0):
        info = self.pgs.get(pg_id)
        if info is None:
            return None
        if info["state"] in ("CREATED", "INFEASIBLE"):
            return info
        ev = self._pg_events.get(pg_id)
        if ev is not None:
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                pass
        return self.pgs.get(pg_id)

    async def handle_remove_placement_group(self, pg_id: str):
        info = self.pgs.pop(pg_id, None)
        self._pg_settled(pg_id)
        self._pg_events.pop(pg_id, None)
        if info is None:
            return False
        self._persist_soon()
        if info.get("placement"):
            # resource return is OFF the reply path (reference: removal is
            # async server-side); agents see the return frames before any
            # later prepare from this same GCS connection, and _schedule_pg
            # quick-retries cover scheduling races.
            by_addr: Dict[str, list] = {}
            for i, (nid, addr) in enumerate(info["placement"]):
                if nid in self.nodes:
                    by_addr.setdefault(addr, []).append(i)

            async def _return(addr: str, indices: list):
                try:
                    await self.agent_clients.get(addr).call_retry(
                        "return_bundles", pg_id=pg_id, indices=indices)
                except Exception:
                    pass

            if not hasattr(self, "_bg_tasks"):
                self._bg_tasks = set()
            for addr, indices in by_addr.items():
                # strong ref until done — the loop holds only weak refs,
                # and a GC'd task would leak the bundle's resources forever
                task = asyncio.ensure_future(_return(addr, indices))
                self._bg_tasks.add(task)
                task.add_done_callback(self._bg_tasks.discard)
        self._publish("pgs", {"pg_id": pg_id, "state": "REMOVED"})
        return True

    async def handle_list_placement_groups(self):
        return list(self.pgs.values())

    # ----------------------------------------------------------------- jobs

    async def handle_register_job(self, metadata: dict | None = None):
        self._job_counter += 1
        jid = JobID(self._job_counter.to_bytes(4, "big"))
        self.jobs[jid.hex()] = {"job_id": jid.hex(), "state": "RUNNING",
                                "start_time": time.time(),
                                "metadata": metadata or {}}
        self._persist()
        return jid.hex()

    async def handle_finish_job(self, job_id: str):
        j = self.jobs.get(job_id)
        if j:
            j.update(state="FINISHED", end_time=time.time())
            self._persist()
        # Job-scoped actor GC: non-detached actors die with their job
        # (reference: GcsActorManager::OnJobFinished); detached ones survive.
        # The by-job index holds only LIVE actors, so a job finish is
        # O(its own survivors) regardless of table size.
        for aid in self._live_actors_by_job.get(job_id):
            info = self.actors.get(aid)
            if (info is not None and info.get("lifetime") != "detached"
                    and info["state"] not in ("DEAD",)):
                await self.handle_kill_actor(aid, no_restart=True)
        return True

    async def handle_list_jobs(self):
        return list(self.jobs.values())

    # ------------------------------------------------------------ task events

    async def handle_add_task_events(self, events: List[dict],
                                     dropped: int = 0,
                                     counters: dict | None = None):
        self.task_events.extend(events)
        if dropped:
            # owners shed events past their bounded buffer; keep the gap
            # visible (state API completeness caveat) instead of silent
            self.task_events_dropped += dropped
        if counters:
            # submission-plane counter snapshot piggybacking the flush
            # (cumulative per owner — latest wins; sched_stats rolls up)
            self.submit_plane_counters[counters.get("owner", "?")] = counters
        return True

    async def handle_list_task_events(self, limit: int = 1000,
                                      filters: dict | None = None):
        out = []
        for ev in reversed(self.task_events):
            if filters and any(ev.get(k) != v for k, v in filters.items()):
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        if self._shard_clients:
            # shard-aware writers append to their own shard's ring; the
            # state API sees ONE merged, newest-first stream
            for slice_ in await self._shard_call_all(
                    "list_task_events", limit=limit, filters=filters):
                out.extend(slice_)
            out.sort(key=lambda e: e.get("ts", 0.0), reverse=True)
            del out[limit:]
        return out

    # ------------------------------------------------------- scheduler explain

    def _on_handler_busy(self, method: str, busy_s: float):
        self._handler_busy[method] = \
            self._handler_busy.get(method, 0.0) + busy_s
        self._handler_calls[method] = self._handler_calls.get(method, 0) + 1
        hist = sched_explain.gcs_handler_hist()
        if hist is not None:
            key = self._gcs_hist_keys.get(method)
            if key is None:
                # shard="router" marks this process's slice of the (now
                # bounded-by-process-count) shard tag; shard processes
                # observe shard="<index>" (gcs_shard._on_handler_busy)
                key = self._gcs_hist_keys[method] = (
                    ("method", method), ("shard", "router"))
            hist.observe_key(key, busy_s)

    def _prune_decisions(self):
        max_age = get_config().sched_decision_max_age_s
        if max_age <= 0:
            return
        cutoff = time.time() - max_age
        d = self.sched_decisions
        while d and d[0].get("ts", 0.0) < cutoff:
            d.popleft()

    def _record_decision(self, record: dict):
        record.setdefault("ts", time.time())
        self._prune_decisions()
        self.sched_decisions.append(record)

    async def handle_add_sched_decisions(self, records: List[dict]):
        """Owner-side decision records (lease-acquisition outcomes) land in
        the same ring as the GCS's own actor/PG placement decisions, so
        ``explain`` sees one trail regardless of who decided."""
        self._prune_decisions()
        self.sched_decisions.extend(records)
        return True

    async def handle_get_sched_decisions(self, limit: int = 200,
                                         id: Optional[str] = None,
                                         kind: Optional[str] = None):
        self._prune_decisions()
        out: List[dict] = []
        for rec in reversed(self.sched_decisions):
            if kind is not None and rec.get("kind") != kind:
                continue
            if id is not None and not self._decision_mentions(rec, id):
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        if self._shard_clients:
            for slice_ in await self._shard_call_all(
                    "get_sched_decisions", limit=limit, id=id, kind=kind):
                out.extend(slice_)
            out.sort(key=lambda r: r.get("ts", 0.0), reverse=True)
            del out[limit:]
        return out

    @staticmethod
    def _decision_mentions(rec: dict, id: str) -> bool:
        if rec.get("id") == id:
            return True
        ids = rec.get("task_ids")
        return bool(ids) and id in ids

    async def handle_explain(self, id: str):
        """The full decision trail for one task / actor / placement group:
        its typed pending-reason transitions (task events), the scheduling
        decision records that mention it, and its current table state —
        the payload behind ``state.explain`` / ``raytpu explain``."""
        self._prune_decisions()
        out: Dict[str, object] = {"id": id, "kind": None}
        # task events: reason transitions + lifecycle, oldest first
        events = [ev for ev in self.task_events
                  if ev.get("task_id") == id or ev.get("actor_id") == id]
        if self._shard_clients:
            for slice_ in await self._shard_call_all("find_task_events",
                                                     id=id):
                events.extend(slice_)
        events.sort(key=lambda e: e.get("ts", 0.0))
        if events:
            out["kind"] = "task"
            out["events"] = events
            latest = max((e for e in events
                          if e.get("state") not in ("STAGES", "SPAN")),
                         key=lambda e: e.get("ts", 0.0), default=None)
            if latest is not None:
                out["state"] = latest.get("state")
                out["name"] = latest.get("name")
                if latest.get("state") == "PENDING":
                    out["pending_reason"] = latest.get("reason")
        info = self.actors.get(id)
        if info is not None:
            out["kind"] = "actor"
            out["actor"] = {k: v for k, v in info.items() if k != "spec"}
            out["state"] = info.get("state")
            if info.get("state") not in ("ALIVE",):
                out["pending_reason"] = info.get("pending_reason")
        pg = self.pgs.get(id)
        if pg is not None:
            out["kind"] = "pg"
            out["pg"] = pg
            out["state"] = pg.get("state")
            if pg.get("state") == "PENDING":
                out["pending_reason"] = pg.get("pending_reason")
        label = out.get("name")
        decisions = [rec for rec in self.sched_decisions
                     if self._decision_mentions(rec, id)
                     or (label is not None and rec.get("label") == label)]
        if self._shard_clients:
            for slice_ in await self._shard_call_all(
                    "get_sched_decisions", id=id, limit=100):
                decisions.extend(slice_)
        decisions.sort(key=lambda r: r.get("ts", 0.0))
        out["decisions"] = decisions[-100:]
        return out

    # --------------------------------------------- object flight recorder

    def _prune_object_events(self):
        max_age = get_config().object_event_max_age_s
        if max_age <= 0:
            return
        cutoff = time.time() - max_age
        d = self.object_events
        while d and d[0].get("ts", 0.0) < cutoff:
            d.popleft()

    async def handle_add_object_events(self, events: List[dict],
                                       dropped: int = 0):
        """Batched object lifecycle transitions from node agents and
        owners land in one ring, so ``explain_object`` sees a single
        trail regardless of which process observed the transition."""
        self._prune_object_events()
        self.object_events.extend(events)
        self.object_events_dropped += dropped
        return True

    async def handle_get_object_events(self, limit: int = 200,
                                       id: Optional[str] = None,
                                       event: Optional[str] = None):
        self._prune_object_events()
        out: List[dict] = []
        for rec in reversed(self.object_events):
            if id is not None and rec.get("object_id") != id:
                continue
            if event is not None and rec.get("event") != event:
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        if self._shard_clients:
            for slice_ in await self._shard_call_all(
                    "get_object_events", limit=limit, id=id, event=event):
                out.extend(slice_)
            out.sort(key=lambda r: r.get("ts", 0.0), reverse=True)
            del out[limit:]
        return out

    async def handle_explain_object(self, id: str):
        """The lifecycle trail of ONE object: its transition events
        (oldest first) with owner/location/tier history, its latest
        state, and rollups (copies seen per node, spill tiers touched) —
        the payload behind ``state.explain_object`` / ``raytpu explain
        <object_id>``."""
        self._prune_object_events()
        events = [ev for ev in self.object_events
                  if ev.get("object_id") == id]
        if self._shard_clients:
            for slice_ in await self._shard_call_all(
                    "get_object_events", id=id, limit=1000):
                events.extend(slice_)
        events.sort(key=lambda e: e.get("ts", 0.0))
        out: Dict[str, object] = {"id": id, "kind": None, "events": events}
        if self.object_events_dropped:
            # an incomplete trail should say so: agents shed events past
            # their 10k buffer and ship the count with every flush
            out["events_dropped"] = self.object_events_dropped
        if not events:
            return out
        out["kind"] = "object"
        latest = events[-1]
        out["state"] = latest.get("event")
        out["size"] = next((e.get("size") for e in reversed(events)
                            if e.get("size") is not None), None)
        out["owner"] = next((e.get("owner") for e in reversed(events)
                             if e.get("owner")), None)
        out["nodes"] = sorted({e.get("node") for e in events
                               if e.get("node")})
        out["tiers"] = sorted({e.get("tier") for e in events
                               if e.get("tier")})
        return out

    # ------------------------------------------------------- health plane

    def _prune_health_alerts(self):
        max_age = get_config().health_alert_max_age_s
        if max_age <= 0:
            return
        cutoff = time.time() - max_age
        d = self.health_alerts
        while d and d[0].get("ts", 0.0) < cutoff:
            d.popleft()

    async def handle_add_health_alerts(self, records: List[dict],
                                       active: Optional[List[dict]] = None,
                                       source: str = "head"):
        """Alert transitions from an external detector (the dashboard
        head's scrape-loop rule subset) land in the same ring as the
        GCS's own; ``active`` is that detector's full current active
        set (latest push wins — handle_health merges it while fresh)."""
        self._prune_health_alerts()
        self.health_alerts.extend(records)
        if active is not None:
            self._health_active_ext[source] = {"ts": time.time(),
                                               "active": list(active)}
        return True

    async def handle_get_health_alerts(self, limit: int = 100,
                                       rule: Optional[str] = None,
                                       kind: Optional[str] = None):
        """Newest-first tail of the alert transition ring."""
        self._prune_health_alerts()
        out: List[dict] = []
        for rec in reversed(self.health_alerts):
            if rule is not None and rec.get("rule") != rule:
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    async def handle_health(self, limit: int = 50):
        """The ``state.health()`` / ``GET /api/health`` payload: the
        deduplicated active-alert set (GCS-side rules merged with the
        head detector's freshest push) plus the recent transition
        trail."""
        from ray_tpu_torch.util import health as health_plane
        self._prune_health_alerts()
        active: List[dict] = []
        det = self._health_detector
        if det is not None:
            active.extend(det.active())
        horizon = time.time() - max(
            60.0, 4 * get_config().metrics_scrape_period_s)
        for ent in self._health_active_ext.values():
            if ent.get("ts", 0.0) >= horizon:
                active.extend(ent.get("active") or [])
        active.sort(key=lambda a: (a.get("severity") != "critical",
                                   a.get("rule", ""), a.get("scope", "")))
        return {
            "enabled": health_plane.enabled(),
            "active": active,
            "recent": list(self.health_alerts)[-limit:][::-1],
            "ring_len": len(self.health_alerts),
            "rules": sorted(health_plane.HealthRule.ALL),
        }

    async def handle_sched_stats(self):
        """Control-plane saturation rollup: per-handler cumulative busy
        seconds + call counts, the GCS loop's busy fraction, and ring
        occupancy — what ``raytpu status`` / ``/api/sched`` /
        bench_scale.py read to name the bottleneck."""
        mon = getattr(self, "_loop_monitor", None)
        busy = {m: round(s, 6) for m, s in self._handler_busy.items()}
        top = sorted(busy.items(), key=lambda kv: kv[1], reverse=True)
        out = {
            "handler_busy_s": busy,
            "handler_calls": dict(self._handler_calls),
            "top_handlers": top[:10],
            "loop_busy_fraction": getattr(mon, "busy_fraction", None),
            "loop_stalls": getattr(mon, "stall_count", None),
            "decision_ring_len": len(self.sched_decisions),
            "task_events_dropped": self.task_events_dropped,
            "object_events_dropped": self.object_events_dropped,
            "object_event_ring_len": len(self.object_events),
            "sched_metrics_enabled": sched_explain.enabled(),
            "submit_plane": dict(self.submit_plane_counters),
        }
        if self._shard_clients:
            # per-shard rollup: there is no longer ONE GCS loop — status
            # surfaces (raytpu status / top, bench_scale) read each shard
            # process's busy fraction + handler attribution from here
            shards = {}
            for st in await self._shard_call_all("shard_stats"):
                shards[str(st.get("shard"))] = st
            out["shards"] = shards
            out["shard_busy_fractions"] = {
                f"gcs_shard:{k}": v.get("loop_busy_fraction")
                for k, v in shards.items()}
            out["task_events_dropped"] += sum(
                v.get("task_events_dropped") or 0 for v in shards.values())
            out["object_events_dropped"] += sum(
                v.get("object_events_dropped") or 0 for v in shards.values())
            # shard-aware owners flush their task events (and the counter
            # snapshot riding them) straight to a shard — merge the maps
            # so sched_stats shows every owner either way
            for v in shards.values():
                for owner, c in (v.get("submit_plane") or {}).items():
                    out["submit_plane"][owner] = c
        return out

    # ------------------------------------------------------------- debug/info

    async def handle_cluster_info(self):
        return {"started_at": self._started_at,
                "num_nodes": sum(1 for n in self.nodes.values() if n.alive),
                "num_actors": len(self.actors),
                "num_pgs": len(self.pgs),
                "num_jobs": len(self.jobs)}

    async def handle_ping(self):
        return "pong"
