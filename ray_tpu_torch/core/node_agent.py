"""Node agent — the per-node runtime daemon (raylet-equivalent).

Plays the role of the reference's raylet (``src/ray/raylet/node_manager.h:125``):

* **Worker pool** — spawns/pools worker subprocesses, prestart, idle reaping
  (reference: ``worker_pool.h:152``).
* **Worker leases** — clients request a lease for a task's resource demand; the agent
  grants an idle/new worker, queues when saturated, or replies with a *spillback* target
  chosen from the cluster view (reference: ``ClusterTaskManager`` queue + spillback,
  ``cluster_task_manager.h:42``; ``HandleRequestWorkerLease`` ``node_manager.cc:1776``).
* **Actor creation** — GCS delegates placement here: the agent leases a dedicated worker
  and pushes the actor-creation task to it (reference: ``GcsActorScheduler`` leasing via
  the same RequestWorkerLease path).
* **Placement-group bundles** — 2-phase prepare/commit resource reservation
  (reference: ``placement_group_resource_manager.h``, ``node_manager.proto:388-395``).
* **Object store service** — hosts the node's shared-memory store; serves create/seal/
  get/free plus chunked node-to-node pulls with admission control (reference: plasma in
  raylet + ``ObjectManager``/``PullManager``, ``object_manager.h:117``, ``pull_manager.h:52``).
* **Health** — heartbeats to GCS with available resources + queue length; monitors worker
  subprocesses and reports actor deaths (reference: heartbeats +
  ``NodeManager::HandleUnexpectedWorkerFailure``).
"""

from __future__ import annotations

import asyncio
import collections
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import chaos, external_spill, object_explain, sched_explain
from .common import (ResourceSet, TaskSpec, detect_node_resources,
                     session_root)
from .config import get_config
from .external_spill import EXTERNAL_NODE_ID, is_external_address
from .ids import NodeID, ObjectID, WorkerID
from .object_store import (ChunkNotAvailable, NodeObjectStore,
                           ObjectStoreFullError, sweep_orphan_spill_dirs)
from .rpc import (ClientPool, ConnectionLost, RemoteError, RpcClient,
                  RpcServer, TransientServerError)
from .scheduling import NodeView, pick_node
from .transfer import (KEY_CHUNK_OUT, KEY_PROXY_IN, ChunkCrcError,
                       ChunkLedger, StripedPull, chunk_checksum,
                       transfer_metrics)

#: True when the asyncio selector transport COPIES unsent write() bytes
#: into its own buffer before returning (<= 3.11).  3.12+ retains the
#: caller's buffer in a zero-copy write queue across loop ticks, so a
#: shm view handed to write() could dangle past an arena recycle.
_TRANSPORT_COPIES_WRITES = sys.version_info < (3, 12)


def _owned_reply_buffer(view: memoryview) -> memoryview:
    """The RPC chunk reply's out-of-band buffer: the zero-copy store view
    itself where the transport consumes writes synchronously (the
    same-tick no-recycle argument in handle_read_chunk), else a
    DELIBERATE defensive copy — on 3.12+ transports the unsent remainder
    of a reply stays a live view across loop ticks, and serving a
    recycled arena range would ship another object's bytes.  The bulk
    channel (pin-protected sends) is the zero-copy path either way."""
    if _TRANSPORT_COPIES_WRITES:
        return view
    return memoryview(bytes(view))

# Lazy singleton: node telemetry gauges (reference: metric_defs.cc core
# metrics).  Module-level so in-process multi-agent clusters (tests, the
# driver-embedded head) share one registry entry per name — each agent's
# samples are separated by the `node` tag.
def _build_telemetry_gauges():
    from ray_tpu_torch.util.metrics import Gauge
    return {
        "workers": Gauge(
            "raytpu_node_workers",
            "worker processes registered to this agent", tag_keys=("node",)),
        "workers_leased": Gauge(
            "raytpu_node_workers_leased",
            "workers currently executing under a lease", tag_keys=("node",)),
        "lease_queue": Gauge(
            "raytpu_node_lease_queue_len",
            "lease requests queued (scheduler backlog)", tag_keys=("node",)),
        "store_used": Gauge(
            "raytpu_object_store_bytes",
            "shm pool bytes in use", tag_keys=("node",)),
        "store_capacity": Gauge(
            "raytpu_object_store_capacity_bytes",
            "shm pool capacity", tag_keys=("node",)),
        "store_free": Gauge(
            "raytpu_object_store_free_bytes",
            "shm pool bytes free", tag_keys=("node",)),
        "store_largest_free": Gauge(
            "raytpu_object_store_largest_free_bytes",
            "largest contiguous free shm block", tag_keys=("node",)),
        "store_objects": Gauge(
            "raytpu_object_store_objects",
            "sealed objects resident in the store", tag_keys=("node",)),
        "store_pinned": Gauge(
            "raytpu_object_store_pinned",
            "store entries with a live pin", tag_keys=("node",)),
        "read_pins": Gauge(
            "raytpu_read_pins_outstanding",
            "zero-copy read pins granted and not yet released",
            tag_keys=("node",)),
        "oom_kills": Gauge(
            "raytpu_node_oom_kills",
            "memory-monitor worker kills since agent start",
            tag_keys=("node",)),
        "resource_available": Gauge(
            "raytpu_resource_available",
            "schedulable capacity currently free",
            tag_keys=("node", "resource")),
        "resource_total": Gauge(
            "raytpu_resource_total",
            "schedulable capacity", tag_keys=("node", "resource")),
        # -- object-plane memory gauges (object_metrics_enabled) --------
        "mem_frag": Gauge(
            "raytpu_mem_arena_frag_fraction",
            "shm arena fragmentation (1 - largest_free/free; 0 = one "
            "contiguous free region)", tag_keys=("node",)),
        "mem_free_blocks": Gauge(
            "raytpu_mem_arena_free_blocks",
            "free blocks in the shm arena (sliver accumulation signal)",
            tag_keys=("node",)),
        "mem_spill_bytes": Gauge(
            "raytpu_mem_spill_bytes",
            "bytes currently resident on a spill tier, by tier",
            tag_keys=("node", "tier")),
        "mem_spill_objects": Gauge(
            "raytpu_mem_spill_objects",
            "objects currently resident on a spill tier, by tier",
            tag_keys=("node", "tier")),
        "mem_leaks": Gauge(
            "raytpu_mem_leak_suspects",
            "ref-debt suspects on this node (pins past TTL + deferred "
            "frees stuck behind vanished pins)", tag_keys=("node",)),
        "disk_used_frac": Gauge(
            "raytpu_node_disk_used_fraction",
            "used fraction of the filesystem holding the session dir "
            "(logs + local spill) — the health plane's DISK_LOW input",
            tag_keys=("node",)),
        "disk_free": Gauge(
            "raytpu_node_disk_free_bytes",
            "free bytes on the session-dir filesystem",
            tag_keys=("node",)),
    }


_telemetry_gauges_get = None


def _telemetry_gauges():
    global _telemetry_gauges_get
    if _telemetry_gauges_get is None:
        # deferred to first call: importing util.metrics at module import
        # time re-enters the ray_tpu_torch package init (circular import)
        from ray_tpu_torch.util.metrics import lazy
        _telemetry_gauges_get = lazy(_build_telemetry_gauges)
    return _telemetry_gauges_get()


@dataclass
class WorkerHandle:
    worker_id: str
    proc: Optional[asyncio.subprocess.Process]
    state: str = "STARTING"          # STARTING | IDLE | LEASED | DRAINING | DEAD
    address: str = ""
    pid: int = 0
    lease_id: Optional[str] = None
    is_actor: bool = False
    actor_id: Optional[str] = None
    probe_failures: int = 0          # consecutive failed idle-reaper probes
    blocked: bool = False
    idle_since: float = field(default_factory=time.monotonic)
    leased_at: float = 0.0           # last IDLE->LEASED transition
    registered: "asyncio.Event" = field(default_factory=asyncio.Event)
    #: pip-env identity: workers run the env's venv interpreter and are only
    #: leased to tasks with the same hash (None = the plain interpreter)
    env_hash: Optional[str] = None
    #: lease provenance for the group-by-owner OOM policy: the submitting
    #: CoreWorker's address and its scheduling-key label
    owner: Optional[str] = None
    task_label: str = ""
    #: (runtime_path, container_name) for containerized workers — killing
    #: the `run` client does not stop the container; teardown must `rm -f`.
    container_ref: Optional[tuple] = None
    #: exit_actor(): the coming process exit is INTENDED — the exit
    #: backstop must report expected=True, never burn a restart
    intended_exit: bool = False


@dataclass
class LeaseRequest:
    lease_id: str
    resources: Dict[str, float]
    bundle: Optional[Tuple[str, int]]  # (pg_id, bundle_index)
    future: "asyncio.Future"
    runtime_env: Optional[dict] = None
    allow_spillback: bool = True
    owner: Optional[str] = None
    task_label: str = ""
    #: the connection the request arrived on: a queued request whose
    #: requester disconnected must NOT be granted a worker nobody will
    #: ever use (the grant would leak the node's capacity forever)
    writer: Optional[object] = None


class NodeAgent:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1", port: int = 0,
                 num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 session_dir: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 object_store_memory: int = 0):
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        self.server = RpcServer(self, host, port, bulk_replies=True)
        self.total = ResourceSet(detect_node_resources(num_cpus, num_gpus, resources))
        self.available = ResourceSet(self.total.to_dict())
        self.labels = dict(labels or {})
        self.labels.setdefault("node_id", self.node_id.hex())
        self.store = NodeObjectStore(self.node_id.hex()[:12], object_store_memory)
        self.workers: Dict[str, WorkerHandle] = {}
        # O(1) dispatch fast path: per-env-hash MRU stack of idle worker
        # ids.  Entries are validated on pop (lazy deletion), so a state
        # change that bypassed the queue can never hand out a stale worker;
        # the full O(n) scan remains as the empty-queue fallback.
        self._idle_ready: Dict[Optional[str], "collections.deque[str]"] = {}
        self.lease_queue: List[LeaseRequest] = []
        self.bundles: Dict[Tuple[str, int], ResourceSet] = {}       # committed
        self.prepared_bundles: Dict[Tuple[str, int], ResourceSet] = {}
        self.gcs: Optional[RpcClient] = None
        self.worker_clients = ClientPool()
        self.agent_clients = ClientPool()
        self.cluster_view: Dict[str, NodeView] = {}
        #: last replayed seq of the GCS dead-lease-owner broadcast (heartbeat
        #: piggyback, same convergence pattern as chaos/shard_map)
        self._dead_owners_seq = 0
        self.session_dir = session_dir or session_root()
        self.worker_env = dict(worker_env or {})
        self._bg: List[asyncio.Task] = []
        self._pull_sem = asyncio.Semaphore(get_config().object_pull_max_concurrency)
        self._inflight_pulls: Dict[ObjectID, "asyncio.Future"] = {}
        self._lease_counter = 0
        self._shutting_down = False
        # Preemption drain state: while draining the agent answers every
        # lease request with backpressure (owners re-pick a node), spills
        # sole-copy objects to the external tier / a peer, waits for
        # outstanding leases to return, then deregisters — with a hard
        # cutoff at the preemption notice deadline.
        self._draining = False
        self._preempt_task: Optional[asyncio.Task] = None
        #: standalone-process hook (node_main sets os._exit): a preempted
        #: node's process must actually disappear; in-process agents
        #: (tests, the driver-embedded head) fall back to stop()
        self._on_preempt_exit = None
        # Same-host identity for zero-copy object sharing: two agents with
        # equal host_key share one /dev/shm, so a "transfer" between them is
        # an mmap attach of the source's pool slice (plasma same-node
        # sharing, generalized across agents).
        import socket as _socket
        try:
            shm_dev = os.stat("/dev/shm").st_dev if os.path.isdir(
                "/dev/shm") else 0
        except OSError:
            shm_dev = 0
        self.host_key = f"{_socket.gethostname()}:{shm_dev}"
        # Read-pin bookkeeping by CONSUMER address (the plasma analogue of
        # releasing a client's pins on socket disconnect): a worker that
        # dies with live zero-copy views — OOM kill, crash — never sends
        # its store_unpin_read, so _on_worker_exit drains its pins here
        # instead of leaking the objects unevictable forever.  Each grant
        # records the store-record KIND it pinned ("local"/"proxy", from
        # pin_for_read) so the release decrements the same record:
        # {consumer_addr: {object_id: {kind: count}}}.
        self._read_pins: Dict[str, Dict[ObjectID, Dict[str, int]]] = {}
        # chaos plane: last runtime spec version applied from the GCS, the
        # kill-schedule task driven by the installed injector, and the
        # runtime spec itself — forwarded to workers spawned AFTER a
        # chaos_set (their RAYTPU_CONFIG_JSON predates it)
        self._chaos_version = 0
        self._chaos_kill_task: Optional[asyncio.Task] = None
        self._chaos_runtime_spec: Optional[dict] = None
        self._chaos_runtime_applied = False
        # Backpressure-reject accounting (the lease-queue admission
        # control's visible half): plain counters always (node_info,
        # bench_scale read them), mirrored into
        # raytpu_sched_backpressure_total{node,reason} when
        # sched_metrics_enabled.  reason in {"depth", "draining"}.
        self._bp_rejects: Dict[str, int] = {}
        self._bp_keys: Dict[str, tuple] = {}
        # worker_id -> memory-monitor kill cause, consumed by the lease
        # return so the owner raises a typed OutOfMemoryError.
        self._oom_kills: Dict[str, str] = {}
        self._oom_kill_count = 0  # lifetime total, exported in stats
        # strong refs to fire-and-forget loop tasks (event writes): the
        # event loop itself only holds weak references
        self._bg_tasks: set = set()
        # per-(owner, object) tail of the location-update chain (see
        # _location_update: add/remove must apply in issue order)
        self._loc_updates: Dict[Tuple[str, ObjectID], "asyncio.Task"] = {}
        # Object-plane flight recorder (core/object_explain.py): bounded
        # buffer of lifecycle transition events flushed to the GCS ring,
        # a bounded ring of completed-pull ChunkLedger end-states
        # (state.transfers()), and first-grant timestamps per (pinner,
        # object) for the pin-TTL leak detector.  All empty/unwritten
        # when object_metrics_enabled is off.
        self._object_events: List[dict] = []
        self._object_events_dropped = 0
        self._transfer_ring: collections.deque = collections.deque(
            maxlen=max(16, get_config().object_transfer_ring_len))
        self._pin_first_ts: Dict[Tuple[str, ObjectID], float] = {}
        self.store.on_object_event = self._buffer_object_event
        # Bulk transfer channel (core/bulk_transfer.py): threaded
        # blocking-socket chunk serving/landing beside the asyncio RPC
        # plane.  Server started in start(); client sockets + the landing
        # executor are lazy.  _bulk_addrs caches peer bulk addresses
        # (None = resolution in flight, False = peer has none).
        self._bulk_server = None
        self._bulk_pool = None
        self._bulk_addrs: Dict[str, object] = {}
        self._transfer_pool = None

    # ------------------------------------------------------------------ boot

    async def start(self):
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        # Orphan sweep: a previous incarnation of a node on this host that
        # died (preemption, SIGKILL) left spill files nothing will ever
        # restore — delete dirs whose writing pid is gone before this
        # incarnation starts accumulating its own.
        if self.store.spill_root:
            try:
                sweep_orphan_spill_dirs(self.store.spill_root)
            except Exception:
                pass
        # External-spill registration hook: once a spill write LANDS, tell
        # the object's owner the external URI is a location (marshalled
        # from the writer thread back onto this agent's loop).
        loop = asyncio.get_event_loop()

        def _on_ext_spill(oid, uri, owner, _loop=loop):
            if owner:
                _loop.call_soon_threadsafe(
                    self._location_update, owner, "add_object_location",
                    oid, EXTERNAL_NODE_ID, uri)

        self.store.on_external_spill = _on_ext_spill
        await self.server.start()
        try:
            from .bulk_transfer import BulkServer

            def _on_bulk_sent(nbytes: int):
                m = transfer_metrics()
                if m is not None:  # Counter.inc_key is lock-protected
                    m["bytes"].inc_key(KEY_CHUNK_OUT, nbytes)

            self._bulk_server = BulkServer(self._bulk_acquire,
                                           self._bulk_release, loop,
                                           host=self.server.host,
                                           on_sent=_on_bulk_sent)
        except Exception:
            self._bulk_server = None  # peers fall back to the RPC path
        if get_config().metrics_export_enabled:
            # before registration: the endpoint port rides the node labels
            await self._start_metrics_endpoint()
        # Shard-aware control-plane client (core/gcs_router.py): this
        # agent's hot fan-in traffic (object-event flushes) goes direct to
        # its shard; register/heartbeat/lease concerns stay on the router.
        from .gcs_router import ShardedGcsClient
        self.gcs = ShardedGcsClient(self.gcs_address,
                                    identity=self.node_id.hex())
        # retried registration with an idempotency token: a lost reply (GCS
        # blip, chaos drop) must not register this node twice
        res = await self.gcs.call_retry(
            "register_node", node_id=self.node_id.hex(),
            address=self.server.address,
            resources=self.total.to_dict(), labels=self.labels)
        self._apply_view(res["cluster_view"])
        self.gcs.apply_shard_map(res.get("shard_map"))
        # start at the GCS's current dead-owner seq: everything before it
        # predates this node (no leases to reclaim), and a fresh agent
        # heartbeating seq=0 would otherwise replay the whole deque
        self._dead_owners_seq = int(res.get("dead_owners_seq", 0))
        # config/env chaos spec: arm the kill schedule (if any) at boot
        self._arm_chaos_schedule()
        self._bg.append(asyncio.ensure_future(self._heartbeat_loop()))
        if get_config().metrics_export_enabled:
            self._bg.append(asyncio.ensure_future(self._telemetry_loop()))
        self._bg.append(asyncio.ensure_future(self._idle_reaper_loop()))
        self._bg.append(asyncio.ensure_future(self._pin_sweep_loop()))
        self._bg.append(asyncio.ensure_future(self._flush_object_events_loop()))
        self._bg.append(asyncio.ensure_future(self._log_monitor_loop()))
        self._bg.append(asyncio.ensure_future(self._memory_monitor_loop()))
        cfg = get_config()
        for _ in range(cfg.prestart_workers):
            asyncio.ensure_future(self._spawn_worker())
        from ray_tpu_torch.util.loop_monitor import install as _install_loop_mon
        self._loop_monitor = _install_loop_mon(
            asyncio.get_event_loop(), f"node_agent:{self.node_id.hex()[:12]}",
            gcs_call=self.gcs.call)
        return self

    @property
    def address(self) -> str:
        return self.server.address

    async def stop(self):
        self._shutting_down = True
        if getattr(self, "_loop_monitor", None):
            self._loop_monitor.stop()
        if self._chaos_kill_task is not None:
            self._chaos_kill_task.cancel()
        for t in self._bg:
            t.cancel()
        for w in list(self.workers.values()):
            await self._kill_worker_proc(w)
        await self.worker_clients.close_all()
        await self.agent_clients.close_all()
        if self.gcs:
            await self.gcs.close()
        if self._bulk_server is not None:
            self._bulk_server.close()
        if self._bulk_pool is not None:
            self._bulk_pool.close()
        if self._transfer_pool is not None:
            self._transfer_pool.shutdown(wait=False)
        await self.server.stop()
        self.store.shutdown()

    def _aggregate_demands(self, max_shapes: int = 50):
        """Queued lease demands as (shape, count) pairs — a wide fan-out must
        not serialize thousands of identical dicts into every heartbeat
        (reference: load reporting aggregates by shape)."""
        counts: Dict[tuple, int] = {}
        for r in self.lease_queue:
            key = tuple(sorted(r.resources.items()))
            counts[key] = counts.get(key, 0) + 1
        return [[dict(k), c] for k, c in list(counts.items())[:max_shapes]]

    def _aggregate_task_leases(self) -> Dict[str, float]:
        """Resources held by short-lived task leases (non-actor, outside any
        PG bundle; blocked leases already released theirs).  Rides the
        heartbeat so elastic capacity probes can treat this slice of a
        busy node as reclaimable headroom rather than permanent load."""
        out: Dict[str, float] = {}
        for w in self.workers.values():
            if (w.state == "LEASED" and w.lease_id and not w.is_actor
                    and not w.blocked
                    and w.lease_id not in self._bundle_of_lease):
                for k, v in (self._lease_resources.get(w.lease_id)
                             or {}).items():
                    out[k] = out.get(k, 0.0) + v
        return out

    def _apply_view(self, payload: Dict[str, dict]):
        self.cluster_view = {
            nid: NodeView(nid, d["address"], d["total"], d["available"],
                          d.get("labels", {}), d.get("alive", True),
                          d.get("queue_len", 0), d.get("draining", False),
                          d.get("task_leased", {}))
            for nid, d in payload.items()}

    async def _heartbeat_loop(self):
        cfg = get_config()
        while not self._shutting_down:
            try:
                res = await self.gcs.call(
                    "heartbeat", node_id=self.node_id.hex(),
                    available=self.available.to_dict(),
                    # total rides every heartbeat so a lost
                    # update_node_resources push self-heals (dynamic
                    # set_resource changes capacity at runtime)
                    total=self.total.to_dict(),
                    queue_len=len(self.lease_queue),
                    queued_demands=self._aggregate_demands(),
                    store_stats=self.store.stats(),
                    chaos_version=self._chaos_version,
                    draining=self._draining,
                    shard_map_version=self.gcs.shard_map_version,
                    dead_owners_seq=self._dead_owners_seq,
                    task_leased=self._aggregate_task_leases())
                if res.get("unknown"):
                    res2 = await self.gcs.call_retry(
                        "register_node", node_id=self.node_id.hex(),
                        address=self.server.address,
                        resources=self.total.to_dict(), labels=self.labels)
                    self._apply_view(res2["cluster_view"])
                    self.gcs.apply_shard_map(res2.get("shard_map"))
                    # adopt the (possibly restarted) GCS's dead-owner seq:
                    # keeping our old, higher counter would make the
                    # heartbeat's `seq < gcs_seq` check silently skip
                    # every new dead-owner broadcast until it caught up
                    self._dead_owners_seq = int(
                        res2.get("dead_owners_seq", 0))
                elif "view" in res:
                    self._apply_view(res["view"])
                if "shard_map" in res:
                    # a shard respawned (or sharding just turned on):
                    # converge via the same piggyback pattern as chaos —
                    # independent of the view above (a reply can carry both)
                    self.gcs.apply_shard_map(res["shard_map"])
                if "chaos" in res:
                    # runtime chaos spec changed at the GCS (chaos_set /
                    # chaos_clear): converge via the heartbeat piggyback
                    await self._apply_chaos(res["chaos"]["spec"],
                                            res["chaos"]["version"])
                if "dead_owners" in res:
                    # confirmed-dead lease owners (killed/crashed actors):
                    # reclaim their orphaned task-worker leases NOW instead
                    # of waiting out the pin sweep's 3-strike probe — an
                    # elastic re-form may be queued on the freed slot
                    self._dead_owners_seq = res["dead_owners"]["seq"]
                    for addr in res["dead_owners"]["addrs"]:
                        await self._drain_read_pins(addr)
                        await self._reclaim_dead_owner_leases(addr)
                if self.lease_queue:
                    await self._process_lease_queue()
            except Exception:
                await asyncio.sleep(0.5)
            await asyncio.sleep(cfg.resource_broadcast_period_s)

    async def _idle_reaper_loop(self):
        cfg = get_config()
        while not self._shutting_down:
            await asyncio.sleep(max(cfg.idle_worker_timeout_s / 2, 0.5))
            now = time.monotonic()
            idle = [w for w in self.workers.values()
                    if w.state == "IDLE" and now - w.idle_since > cfg.idle_worker_timeout_s]
            # Keep a small warm pool; reap the rest (reference:
            # idle_worker_killing_time_threshold_ms).
            keep = int(self.total.get("CPU"))
            n_idle = sum(1 for w in self.workers.values() if w.state == "IDLE")
            for w in idle:
                if n_idle <= keep:
                    break
                # A worker that owns live objects (in-process store non-empty)
                # must not be reaped: borrowers would lose the data (the
                # reference keeps object data in node-level plasma precisely so
                # worker exit doesn't destroy it; our inline small objects live
                # with their owner).
                try:
                    client = self.worker_clients.get(w.address)
                    owned = await client.call("owned_object_count",
                                              _timeout=2.0)
                except Exception:
                    # Fail closed on transient probe errors, but escalate: a
                    # worker whose RPC channel is wedged for 3 consecutive
                    # probes with no lease is dead weight — reap it.
                    w.probe_failures = getattr(w, "probe_failures", 0) + 1
                    if w.probe_failures < 3 or w.state != "IDLE":
                        continue
                    owned = 0
                else:
                    w.probe_failures = 0
                if owned:
                    continue
                # Re-check after the await: the worker may have been leased
                # while the probe was in flight.
                if w.state != "IDLE":
                    continue
                # DRAINING before the async kill so the lease path cannot
                # hand work to a dying worker mid-kill.
                w.state = "DRAINING"
                await self._kill_worker_proc(w)
                n_idle -= 1

    # ----------------------------------------------------------- worker pool

    async def _spawn_worker(self, is_actor: bool = False,
                            runtime_env: Optional[dict] = None
                            ) -> WorkerHandle:
        from .runtime_env import (conda_env_hash, materialize_conda_env,
                                  materialize_pip_env, pip_env_hash,
                                  worker_env_hash)
        env_hash = worker_env_hash(runtime_env)
        python_exe = sys.executable
        if pip_env_hash(runtime_env) is not None:
            # Build (or reuse) the env's venv off-loop — pip takes seconds —
            # and launch the worker under its interpreter so the task sees
            # the env's package versions, isolated from every other env
            # (reference: _private/runtime_env/pip.py + worker startup).
            from .common import RuntimeEnvSetupError
            try:
                python_exe = await asyncio.get_event_loop().run_in_executor(
                    None, materialize_pip_env, self.session_dir, runtime_env)
            except Exception as e:
                raise RuntimeEnvSetupError(str(e)) from e
        elif conda_env_hash(runtime_env) is not None:
            # Same off-loop materialization for conda (reference:
            # _private/runtime_env/conda.py) — workers launch under the
            # conda env's interpreter, pooled per spec hash.
            from .common import RuntimeEnvSetupError
            try:
                python_exe = await asyncio.get_event_loop().run_in_executor(
                    None, materialize_conda_env, self.session_dir,
                    runtime_env)
            except Exception as e:
                raise RuntimeEnvSetupError(str(e)) from e
        worker_id = WorkerID.from_random().hex()
        env = dict(os.environ)
        env.update(self.worker_env)
        # Ensure spawned workers can import ray_tpu_torch regardless of their cwd.
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env.update({
            "RAYTPU_GCS_ADDRESS": self.gcs_address,
            "RAYTPU_AGENT_ADDRESS": self.server.address,
            "RAYTPU_NODE_ID": self.node_id.hex(),
            "RAYTPU_WORKER_ID": worker_id,
            "RAYTPU_CONFIG_JSON": get_config().to_json(),
            "RAYTPU_SESSION_DIR": self.session_dir,
        })
        container = (runtime_env or {}).get("container")
        container_ref = None
        if container:
            # Container isolation (reference: runtime_env/container.py):
            # the worker runs inside `podman/docker run` sharing host
            # network, IPC + /dev/shm (object store), session dir, and the
            # framework source read-only.  The argv builds BEFORE the log
            # file opens so a missing-runtime error leaks no fd.
            from .common import RuntimeEnvSetupError
            from .runtime_env import container_worker_argv
            cname = f"raytpu-{worker_id[:12]}"
            try:
                argv = container_worker_argv(
                    container, self.session_dir, pkg_root, env,
                    passthrough=set(self.worker_env), name=cname)
            except Exception as e:  # noqa: BLE001 — deterministic config
                raise RuntimeEnvSetupError(str(e)) from e
            container_ref = (argv[0], cname)
        log = os.path.join(self.session_dir, "logs", f"worker-{worker_id[:12]}.log")
        logf = open(log, "ab", buffering=0)
        if container:
            proc = await asyncio.create_subprocess_exec(
                *argv, stdout=logf, stderr=logf, env=env)
        else:
            proc = await asyncio.create_subprocess_exec(
                python_exe, "-m", "ray_tpu_torch.core.worker_main",
                stdout=logf, stderr=logf, env=env)
        w = WorkerHandle(worker_id=worker_id, proc=proc, pid=proc.pid,
                         is_actor=is_actor, env_hash=env_hash)
        w.container_ref = container_ref
        self.workers[worker_id] = w
        asyncio.ensure_future(self._monitor_worker(w))
        return w

    async def _monitor_worker(self, w: WorkerHandle):
        if w.proc is None:
            return
        await w.proc.wait()
        await self._on_worker_exit(w, f"worker process exited with code {w.proc.returncode}")

    async def _on_worker_exit(self, w: WorkerHandle, reason: str):
        if w.state == "DEAD":
            return
        prev_state = w.state
        w.state = "DEAD"
        self.workers.pop(w.worker_id, None)
        # drop the dead worker's pushed metric snapshot: under worker
        # churn the per-reporter map would otherwise keep one stale
        # registry copy per dead worker forever (every scrape re-renders
        # them as live series)
        if hasattr(self, "_metrics"):
            self._metrics.pop(f"worker-{w.worker_id[:12]}", None)
        await self._drain_read_pins(w.address)
        # Wake any _grant_lease waiter parked on registration (a worker that
        # crashes during boot must fail the grant now, not after the full
        # register timeout) — same handshake as _kill_worker_proc.
        w.registered.set()
        if prev_state == "LEASED" and w.lease_id and not w.is_actor:
            if w.blocked:  # resources were already released at block time
                self._lease_resources.pop(w.lease_id, None)
            else:
                self._release_lease_resources(w.lease_id)
        if w.is_actor and w.actor_id and not self._shutting_down:
            try:
                # retried + idempotency token: a lost reply must not burn
                # TWO restarts for one death
                if w.intended_exit:
                    # exit_actor(): the worker announced the exit before
                    # dying — even if its own GCS report was lost, this
                    # backstop must not trigger a restart
                    await self.gcs.call_retry(
                        "report_actor_death", actor_id=w.actor_id,
                        reason="exit_actor() (intended)", expected=True)
                else:
                    await self.gcs.call_retry("report_actor_death",
                                              actor_id=w.actor_id,
                                              reason=reason)
            except Exception:
                pass
            if w.lease_id:
                if w.blocked:
                    self._lease_resources.pop(w.lease_id, None)
                else:
                    self._release_lease_resources(w.lease_id)
        await self._process_lease_queue()

    async def _kill_worker_proc(self, w: WorkerHandle):
        was_dead = w.state == "DEAD"
        w.state = "DEAD"
        self.workers.pop(w.worker_id, None)
        if hasattr(self, "_metrics"):  # see _on_worker_exit
            self._metrics.pop(f"worker-{w.worker_id[:12]}", None)
        if not was_dead:
            await self._drain_read_pins(w.address)
        # Release any lease the victim held (kill paths bypass _on_worker_exit,
        # which early-returns once the state is DEAD).
        if not was_dead and w.lease_id:
            if w.blocked:
                w.blocked = False
                self._lease_resources.pop(w.lease_id, None)
                self._bundle_of_lease.pop(w.lease_id, None)
            else:
                self._release_lease_resources(w.lease_id)
            w.lease_id = None
        if w.container_ref is not None:
            # SIGKILLing the podman/docker CLIENT leaves the container (and
            # the worker inside it) running; remove it by name.
            runtime, cname = w.container_ref
            try:
                await asyncio.create_subprocess_exec(
                    runtime, "rm", "-f", cname,
                    stdout=asyncio.subprocess.DEVNULL,
                    stderr=asyncio.subprocess.DEVNULL)
            except Exception:
                pass
        if w.proc is not None:
            try:
                w.proc.kill()
            except ProcessLookupError:
                pass
        # Wake any _grant_lease waiter parked on registration: the grant
        # must fail NOW (state is DEAD), not after the register timeout.
        w.registered.set()
        if not was_dead and not self._shutting_down:
            await self._process_lease_queue()

    async def handle_register_worker(self, worker_id: str, address: str, pid: int):
        w = self.workers.get(worker_id)
        if w is None:
            return {"shutdown": True}
        w.address = address
        w.pid = pid
        if w.state == "STARTING":
            w.state = "IDLE"
            w.idle_since = time.monotonic()
            self._mark_idle_ready(w)
        w.registered.set()
        if self._chaos_runtime_applied:
            # a runtime chaos_set happened before this worker existed: its
            # serialized config predates the spec, so hand it over now
            try:
                await self.worker_clients.get(address).notify(
                    "chaos_update", spec=self._chaos_runtime_spec)
            except Exception:
                pass
        await self._process_lease_queue()
        return {"node_id": self.node_id.hex(), "store_name": self.store.name}

    # --------------------------------------------------------------- leases

    @property
    def _lease_resources(self) -> Dict[str, Dict[str, float]]:
        if not hasattr(self, "_lease_res_map"):
            self._lease_res_map: Dict[str, Dict[str, float]] = {}
        return self._lease_res_map

    def _next_lease_id(self) -> str:
        self._lease_counter += 1
        return f"{self.node_id.hex()[:8]}-{self._lease_counter}"

    def _note_backpressure(self, reason: str):
        """Count a backpressure-rejected lease request (reason: "depth" =
        lease queue at its bound, "draining" = preemption notice)."""
        self._bp_rejects[reason] = self._bp_rejects.get(reason, 0) + 1
        c = sched_explain.backpressure_counter()
        if c is not None:
            key = self._bp_keys.get(reason)
            if key is None:
                key = self._bp_keys[reason] = (
                    ("node", self.node_id.hex()[:12]), ("reason", reason))
            c.inc_key(key)

    def _resource_pool_for(self, bundle: Optional[Tuple[str, int]]) -> ResourceSet:
        if bundle is not None:
            rs = self.bundles.get(tuple(bundle))
            if rs is None:
                raise ValueError(f"unknown placement bundle {bundle}")
            return rs
        return self.available

    async def handle_request_worker_lease(self, resources: Dict[str, float],
                                          bundle: Optional[Tuple[str, int]] = None,
                                          runtime_env: Optional[dict] = None,
                                          allow_spillback: bool = True,
                                          owner: Optional[str] = None,
                                          task_label: str = "",
                                          _writer=None):
        """Grant {worker_address, worker_id, lease_id} | {spillback: node} | queue.

        Grants are tied to the REQUESTING CONNECTION: a grant that
        completes after the requester's connection died is undeliverable —
        returning it as a reply would vanish into a closed socket while
        the lease pins the node's resources forever.  Reclaim the worker
        and raise instead; the error lands in the idempotency cache, so a
        same-token retry re-requests cleanly (and a requester that truly
        gave up leaks nothing)."""
        grant = await self._request_worker_lease(
            resources, bundle, runtime_env, allow_spillback, owner,
            task_label, _writer)
        if (_writer is not None and _writer.is_closing()
                and isinstance(grant, dict) and "lease_id" in grant):
            await self.handle_return_worker_lease(
                grant["lease_id"], grant["worker_id"], worker_alive=True)
            # TransientServerError: dropped from the dedup cache, so a
            # same-token retry on a LIVE connection re-executes and gets a
            # fresh grant instead of replaying this stale error
            raise TransientServerError(
                "lease grant undeliverable: requester connection closed")
        return grant

    handle_request_worker_lease.rpc_pass_writer = True

    async def handle_request_worker_leases(self, count: int,
                                           resources: Dict[str, float],
                                           bundle: Optional[Tuple[str, int]] = None,
                                           runtime_env: Optional[dict] = None,
                                           allow_spillback: bool = True,
                                           owner: Optional[str] = None,
                                           task_label: str = "",
                                           _writer=None):
        """Batched lease grant: up to ``count`` workers in ONE round trip.

        -> {"grants": [grant, ...]} | {"spillback": ...} | {"infeasible": ...}

        The fast path reserves each slot's resources SYNCHRONOUSLY (no
        await between the can_fit check and the acquire), then finishes the
        grants concurrently — a cold batch spawns its workers in parallel
        exactly like ``count`` independent lease RPCs used to, minus the
        per-lease round trips.  When nothing is grantable right now the
        request degrades to the single-lease slow path (queue park /
        spillback / infeasible), preserving those semantics unchanged."""
        count = max(1, int(count))
        if self._draining:
            self._note_backpressure("draining")
            return {"backpressure": True,
                    "retry_after_s": get_config().lease_backpressure_retry_s}
        pending = []
        pool = self._resource_pool_for(bundle)  # ValueError surfaces as-is
        feasible = (bundle is not None
                    or ResourceSet(self.total.to_dict()).can_fit(resources))
        if feasible:
            while len(pending) < count and pool.can_fit(resources):
                pool.acquire(resources)
                pending.append(self._grant_lease(
                    resources, bundle, runtime_env, owner=owner,
                    task_label=task_label, pre_acquired=True))
        if pending:
            out = await asyncio.gather(*pending, return_exceptions=True)
            grants = [g for g in out if isinstance(g, dict)]
            errors = [g for g in out if not isinstance(g, dict)]
            if not grants:
                raise errors[0]
            if errors:
                # Partial failure with partial success: the reply can only
                # carry the grants, but the cause must not vanish — the
                # owner reads a short grant list as "saturated" and simply
                # re-requests, so this log line is the ONLY place a
                # recurring spawn/register failure surfaces.
                try:
                    print(f"[node-agent] {len(errors)}/{len(out)} lease "
                          f"grants in a batch failed: {errors[0]!r}",
                          flush=True)
                except Exception:
                    pass
            if _writer is not None and _writer.is_closing():
                # undeliverable (same contract as the single-lease handler):
                # reclaim every granted worker and let a same-token retry
                # on a live connection re-execute
                for g in grants:
                    await self.handle_return_worker_lease(
                        g["lease_id"], g["worker_id"], worker_alive=True)
                raise TransientServerError(
                    "lease grant undeliverable: requester connection closed")
            return {"grants": grants}
        g = await self.handle_request_worker_lease(
            resources, bundle=bundle, runtime_env=runtime_env,
            allow_spillback=allow_spillback, owner=owner,
            task_label=task_label, _writer=_writer)
        if isinstance(g, dict) and "worker_address" in g:
            return {"grants": [g]}
        return g

    handle_request_worker_leases.rpc_pass_writer = True

    async def _request_worker_lease(self, resources, bundle, runtime_env,
                                    allow_spillback, owner, task_label,
                                    writer=None):
        if self._draining:
            # preemption notice received: stop accepting work — the owner
            # folds this into node re-picking exactly like depth-bound
            # backpressure, and the GCS view's draining flag keeps fresh
            # picks away
            self._note_backpressure("draining")
            return {"backpressure": True,
                    "retry_after_s": get_config().lease_backpressure_retry_s}
        pool = self._resource_pool_for(bundle)
        if bundle is None and not ResourceSet(self.total.to_dict()).can_fit(resources):
            return {"infeasible": True}
        if pool.can_fit(resources):
            return await self._grant_lease(resources, bundle, runtime_env,
                                           owner=owner, task_label=task_label)
        # Saturated: spill to a node that can run it now (reference spillback).
        spill = self._spillback_target(resources) if (allow_spillback and
                                                      bundle is None) else None
        if spill is not None:
            return spill
        cfg = get_config()
        if (cfg.lease_queue_max_depth > 0
                and len(self.lease_queue) >= cfg.lease_queue_max_depth):
            # Lease-queue admission control: parking past the depth bound
            # would grow agent memory without bound under a million-task
            # burst (every parked request pins a future + writer ref).
            # Tell the owner to back off and re-route instead.
            self._note_backpressure("depth")
            return {"backpressure": True,
                    "retry_after_s": cfg.lease_backpressure_retry_s}
        fut = asyncio.get_event_loop().create_future()
        req = LeaseRequest(self._next_lease_id(), resources,
                           tuple(bundle) if bundle else None, fut, runtime_env,
                           allow_spillback=allow_spillback,
                           owner=owner, task_label=task_label,
                           writer=writer)
        self.lease_queue.append(req)
        return await fut

    async def on_disconnect(self, peer, writer):
        """A client connection died: fail its queued lease requests NOW.
        Leaving them queued would eventually grant workers to a requester
        that cannot hear the reply — each such grant permanently leaks a
        slice of this node's capacity (the wedge the chaos harness hits
        within seconds at a 5% frame-drop rate)."""
        stale = [r for r in self.lease_queue if r.writer is writer]
        for req in stale:
            self.lease_queue.remove(req)
            if not req.future.done():
                req.future.set_exception(TransientServerError(
                    "requester disconnected before lease grant"))

    def _spillback_target(self, resources: Dict[str, float]) -> Optional[dict]:
        others = {nid: v for nid, v in self.cluster_view.items()
                  if nid != self.node_id.hex()}
        target = pick_node(others, resources, "DEFAULT")
        if target is not None and others[target].can_fit_now(resources):
            return {"spillback": {"node_id": target,
                                  "address": others[target].address}}
        return None

    async def _grant_lease(self, resources, bundle, runtime_env,
                           owner: Optional[str] = None,
                           task_label: str = "",
                           pre_acquired: bool = False) -> dict:
        from .runtime_env import worker_env_hash
        pool = self._resource_pool_for(bundle)
        if not pre_acquired:
            # batched grants reserve synchronously BEFORE their coroutines
            # interleave (see handle_request_worker_leases) so concurrent
            # slots cannot over-commit the pool
            pool.acquire(resources)
        lease_id = self._next_lease_id()
        if bundle is None:
            self._lease_resources[lease_id] = dict(resources)
        else:
            self._lease_resources[lease_id] = {}
            self._bundle_of_lease[lease_id] = (tuple(bundle), dict(resources))
        env_hash = worker_env_hash(runtime_env)
        w = self._pop_idle_worker(env_hash)
        if w is None:
            try:
                w = await self._spawn_worker(runtime_env=runtime_env)
            except Exception:
                # env materialization / spawn failed: the acquired resources
                # must go back or the node bleeds capacity on every retry
                self._release_lease_resources(lease_id)
                raise
        w.state = "LEASED"
        w.leased_at = time.monotonic()
        w.lease_id = lease_id
        w.owner = owner
        w.task_label = task_label
        try:
            await asyncio.wait_for(w.registered.wait(),
                                   get_config().worker_register_timeout_s)
        except asyncio.TimeoutError:
            await self._kill_worker_proc(w)  # releases the lease resources
            raise RuntimeError("worker failed to register in time")
        if w.state == "DEAD":
            # A kill path (drain, node stop) reaped this worker while it was
            # booting and set the event to wake us; the kill already released
            # the lease resources.  Fail fast so the owner retries at once.
            raise RuntimeError("worker was killed before registering")
        return {"worker_address": w.address, "worker_id": w.worker_id,
                "lease_id": lease_id, "node_id": self.node_id.hex()}

    @property
    def _bundle_of_lease(self) -> Dict[str, Tuple[Tuple[str, int], Dict[str, float]]]:
        if not hasattr(self, "_bundle_lease_map"):
            self._bundle_lease_map = {}
        return self._bundle_lease_map

    def _release_lease_resources(self, lease_id: str):
        if lease_id in self._bundle_of_lease:
            bundle, res = self._bundle_of_lease.pop(lease_id)
            rs = self.bundles.get(bundle)
            if rs is not None:
                rs.release(res)
        else:
            self.available.release(self._lease_resources.get(lease_id, {}))
        self._lease_resources.pop(lease_id, None)

    def _mark_idle_ready(self, w: WorkerHandle):
        """Push a worker that just became IDLE onto the O(1) ready stack
        (MRU at the right — the most recently idled worker has the warmest
        caches and is popped first)."""
        self._idle_ready.setdefault(w.env_hash, collections.deque()) \
            .append(w.worker_id)

    def _pop_idle_worker(self, env_hash: Optional[str] = None
                         ) -> Optional[WorkerHandle]:
        # Fast path: pop from the per-env ready stack, skipping stale
        # entries (workers that died or were leased through another path).
        dq = self._idle_ready.get(env_hash)
        while dq:
            w = self.workers.get(dq.pop())
            if w is not None and w.state == "IDLE" and w.env_hash == env_hash:
                return w
        # Fallback scan: catches IDLE workers that reached the state
        # without passing _mark_idle_ready.
        best = None
        for w in self.workers.values():
            if w.state == "IDLE" and w.env_hash == env_hash:
                if best is None or w.idle_since > best.idle_since:
                    best = w  # MRU: keep caches warm
        return best

    async def handle_worker_blocked(self, worker_id: str):
        """A leased worker blocked on get/wait: release its lease resources so
        nested tasks can run on this node (reference: raylet releases CPU for
        blocked workers — local_task_manager dispatch accounting)."""
        w = self.workers.get(worker_id)
        if (w is not None and w.state == "LEASED" and w.lease_id
                and not w.blocked):
            res = self._lease_resources.get(w.lease_id)
            if res:
                w.blocked = True
                self.available.release(res)
                await self._process_lease_queue()
        return True

    async def handle_worker_unblocked(self, worker_id: str):
        w = self.workers.get(worker_id)
        if w is not None and w.blocked:
            w.blocked = False
            res = self._lease_resources.get(w.lease_id or "", {})
            self.available.force_acquire(res)
        return True

    async def handle_worker_intended_exit(self, worker_id: str):
        """A worker announces its coming exit is deliberate (exit_actor):
        the process-exit backstop reports expected=True so no restart is
        burned even if the worker's own GCS report was lost."""
        w = self.workers.get(worker_id)
        if w is not None:
            w.intended_exit = True
        return True

    async def handle_set_resource(self, name: str, capacity: float):
        """Adjust this node's capacity for one resource at runtime
        (reference: ``experimental/dynamic_resources.py`` set_resource —
        capacity 0 deletes the resource).  Available shifts by the same
        delta (it may go transiently negative while leases drain, exactly
        like the reference's resource deletion under load)."""
        name = str(name)
        capacity = float(capacity)
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        delta = capacity - self.total.get(name)
        self.total.set(name, capacity)
        # ALWAYS shift available by delta — deleting while leases hold the
        # resource must leave available negative so the eventual lease
        # returns settle back to zero, never to phantom capacity.
        self.available.set(name, self.available.get(name) + delta)
        try:
            await self.gcs.call("update_node_resources",
                                node_id=self.node_id.hex(),
                                total=self.total.to_dict(),
                                available=self.available.to_dict())
        except Exception:
            pass  # the next heartbeat carries available; view self-heals
        await self._process_lease_queue()
        return {"total": self.total.to_dict()}

    async def handle_return_worker_lease(self, lease_id: str, worker_id: str,
                                         worker_alive: bool = True):
        # Surface the death cause to the owner: an OOM-killed worker's task
        # should fail with a typed OutOfMemoryError naming the policy, not a
        # generic WorkerCrashedError.
        death_cause = self._oom_kills.pop(worker_id, None)
        w0 = self.workers.get(worker_id)
        if w0 is not None and w0.blocked and w0.lease_id == lease_id:
            # Block already released the resources; just drop the record.
            w0.blocked = False
            self._lease_resources.pop(lease_id, None)
            self._bundle_of_lease.pop(lease_id, None)
        else:
            self._release_lease_resources(lease_id)
        w = self.workers.get(worker_id)
        if w is not None and w.lease_id == lease_id:
            if worker_alive and w.state == "LEASED":
                w.state = "IDLE"
                w.lease_id = None
                w.idle_since = time.monotonic()
                self._mark_idle_ready(w)
            elif not worker_alive:
                await self._kill_worker_proc(w)
        await self._process_lease_queue()
        return {"ok": True, "death_cause": death_cause}

    async def _process_lease_queue(self):
        i = 0
        while i < len(self.lease_queue):
            req = self.lease_queue[i]
            if req.writer is not None and req.writer.is_closing():
                # requester's connection died while queued (see
                # on_disconnect; this catches the race where the writer
                # closed without the disconnect callback yet): granting
                # would leak the worker
                self.lease_queue.pop(i)
                if not req.future.done():
                    req.future.set_exception(TransientServerError(
                        "requester disconnected before lease grant"))
                continue
            try:
                pool = self._resource_pool_for(req.bundle)
            except ValueError:
                self.lease_queue.pop(i)
                if not req.future.done():
                    req.future.set_exception(ValueError(f"bundle {req.bundle} removed"))
                continue
            if req.bundle is None and not ResourceSet(
                    self.total.to_dict()).can_fit(req.resources):
                # capacity shrank below the demand after admission
                # (dynamic set_resource): answer infeasible NOW — same
                # response the admission check would give a fresh request —
                # so the owner re-routes instead of waiting forever.
                self.lease_queue.pop(i)
                if not req.future.done():
                    req.future.set_result({"infeasible": True})
                continue
            if pool.can_fit(req.resources):
                self.lease_queue.pop(i)
                try:
                    grant = await self._grant_lease(req.resources, req.bundle,
                                                    req.runtime_env,
                                                    owner=req.owner,
                                                    task_label=req.task_label)
                    if not req.future.done():
                        req.future.set_result(grant)
                except Exception as e:  # noqa: BLE001
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            # Re-evaluate spillback for queued requests: the cluster view may
            # have been stale (or other nodes freed up) since the request was
            # queued (reference: ClusterTaskManager retries spillback on each
            # scheduling pass).
            if req.allow_spillback and req.bundle is None:
                spill = self._spillback_target(req.resources)
                if spill is not None:
                    self.lease_queue.pop(i)
                    if not req.future.done():
                        req.future.set_result(spill)
                    continue
            i += 1

    async def handle_node_stacks(self) -> Dict[str, str]:
        """Stack dumps of every registered worker on this node plus the
        agent itself (reference: dashboard/modules/reporter stack traces)."""
        from ray_tpu_torch.util.debug import dump_all_stacks
        out: Dict[str, str] = {}
        out["agent"] = dump_all_stacks()
        for w in list(self.workers.values()):
            if not w.address:
                continue
            try:
                out[f"worker-{w.worker_id[:12]}"] = await self.worker_clients \
                    .get(w.address).call("dump_stacks", _timeout=5.0)
            except Exception as e:  # noqa: BLE001
                out[f"worker-{w.worker_id[:12]}"] = f"<unavailable: {e}>"
        return out

    async def handle_profile(self, duration_s: float = 2.0,
                             worker_id: Optional[str] = None):
        """On-demand profiler capture on this node (``raytpu profile
        --node <id> --duration <s>``): forwards to a registered worker —
        that's the process holding the CUDA context, so a GPU worker
        answers with a ``torch.profiler`` chrome trace and a CPU worker
        with sampled thread stacks as chrome-trace JSON.  LEASED workers
        are preferred (the train/serve step is what the operator wants to
        see); a node with no reachable worker profiles the agent itself.
        Returns {"path", "mode", "process"} — the artifact lands under
        the node's session dir."""
        out_dir = os.path.join(self.session_dir, "profiles")
        candidates = [w for w in self.workers.values()
                      if w.address and (worker_id is None
                                        or w.worker_id.startswith(worker_id))]
        candidates.sort(key=lambda w: w.state != "LEASED")
        for w in candidates[:3]:
            try:
                return await self.worker_clients.get(w.address).call(
                    "profile", duration_s=duration_s, out_dir=out_dir,
                    _timeout=duration_s + 30.0)
            except Exception:
                continue
        from ray_tpu_torch.util import profiler
        loop = asyncio.get_event_loop()
        path, mode = await loop.run_in_executor(
            None, lambda: profiler.capture(duration_s, out_dir))
        return {"path": path, "mode": mode, "process": "agent"}

    async def handle_kill_worker(self, worker_id: str, reason: str = ""):
        w = self.workers.get(worker_id)
        if w is None:
            return False
        await self._kill_worker_proc(w)
        return True

    # ---------------------------------------------------------------- chaos

    async def handle_chaos_update(self, spec: Optional[dict],
                                  version: int | None = None):
        """Runtime chaos control reached this node (GCS chaos_set via
        pubsub/heartbeat, or a direct call): install the spec locally,
        re-arm the kill schedule, and forward to every registered worker."""
        await self._apply_chaos(spec, version)
        return True

    async def _apply_chaos(self, spec: Optional[dict],
                           version: int | None = None):
        chaos.install(spec)
        self._chaos_runtime_spec = spec
        self._chaos_runtime_applied = True
        if version is not None:
            self._chaos_version = version
        self._arm_chaos_schedule()
        for w in list(self.workers.values()):
            if not w.address:
                continue
            try:
                await self.worker_clients.get(w.address).notify(
                    "chaos_update", spec=spec)
            except Exception:
                pass

    def _arm_chaos_schedule(self):
        """(Re)start the seeded kill-schedule loop for the installed
        injector (the NodeKillerActor analogue, reference:
        test_utils.py:1401 — here at worker granularity: agent/node kills
        stay with Cluster.kill_node)."""
        if self._chaos_kill_task is not None:
            self._chaos_kill_task.cancel()
            self._chaos_kill_task = None
        inj = chaos.injector()
        if inj is None or not inj.kills:
            return
        self._chaos_kill_task = asyncio.ensure_future(
            self._chaos_kill_loop(inj))

    async def _chaos_kill_loop(self, inj):
        t0 = time.monotonic()
        my_id = self.node_id.hex()
        for entry in sorted(inj.kills, key=lambda k: float(k.get("after_s", 0))):
            node_sel = entry.get("node")
            if node_sel and not my_id.startswith(str(node_sel)):
                continue
            kind = entry.get("kind") or entry.get("target", "worker")
            if kind not in ("worker", "preempt_node", "node"):
                continue
            delay = t0 + float(entry.get("after_s", 0)) - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            if kind in ("preempt_node", "node"):
                # Seeded node preemption: deliver the shutdown notice to
                # OURSELVES — notice_s>0 exercises the graceful drain,
                # notice_s=0 the no-warning hard kill.  This agent is
                # going away; stop walking the schedule.
                if self._shutting_down:
                    return
                inj.record("preempt_node")
                self._begin_preemption(float(entry.get("notice_s", 0.0)))
                return
            # A scheduled kill with no victim yet (workers still booting)
            # waits briefly so "1 scheduled kill" reliably means 1 kill.
            victim = None
            for _ in range(100):
                if self._shutting_down:
                    return
                victim = self._pick_chaos_victim()
                if victim is not None:
                    break
                await asyncio.sleep(0.1)
            if victim is None:
                continue
            inj.record("worker_kill")
            try:
                print(f"[chaos] killing worker {victim.worker_id[:12]} "
                      f"(seeded schedule, node {my_id[:12]})", flush=True)
            except Exception:
                pass
            await self._kill_worker_proc(victim)

    def _pick_chaos_victim(self):
        """Deterministic victim: the first registered NON-ACTOR worker by
        worker id (leased preferred — killing it exercises the task-retry
        path; actors are spared so a kill never burns an actor restart
        the workload did not budget for)."""
        live = sorted((w for w in self.workers.values()
                       if w.registered.is_set() and not w.is_actor
                       and w.state in ("IDLE", "LEASED")),
                      key=lambda w: w.worker_id)
        leased = [w for w in live if w.state == "LEASED"]
        pool = leased or live
        return pool[0] if pool else None

    # ----------------------------------------------------- preemption drain

    async def handle_drain_self(self, notice_s: float = 0.0):
        """Deliver a preemption notice to this node (the cloud provider's
        shutdown warning, an operator drain, or the chaos plane's seeded
        ``preempt_node``).  ``notice_s > 0`` drains gracefully — stop
        accepting leases, re-home sole-copy objects, let outstanding
        leases return — with a HARD cutoff when the notice expires;
        ``notice_s = 0`` is the no-warning preemption (the node just
        disappears, recovery rides the external tier + lineage)."""
        self._begin_preemption(notice_s)
        return True

    def _begin_preemption(self, notice_s: float):
        if self._preempt_task is not None or self._shutting_down:
            return
        self._preempt_task = asyncio.ensure_future(self._preempt(notice_s))

    async def _preempt(self, notice_s: float):
        notice_s = max(0.0, float(notice_s))
        try:
            print(f"[preempt] node {self.node_id.hex()[:12]}: preemption "
                  f"notice, {notice_s:.1f}s to drain", flush=True)
        except Exception:
            pass
        if notice_s <= 0:
            await self._preempt_finish(graceful=False)
            return
        self._draining = True
        deadline = time.monotonic() + notice_s
        # tell the GCS at drain START (not the end): the notice is the
        # elastic train plane's advance warning — a trainer with workers
        # here resizes DOWN inside the notice window instead of eating an
        # actor death.  Best-effort: a lost report just means the slower
        # heartbeat-draining path carries the flag.
        try:
            await asyncio.wait_for(
                self.gcs.call("report_drain_notice",
                              node_id=self.node_id.hex(),
                              notice_s=notice_s),
                timeout=min(2.0, notice_s / 2))
        except Exception:
            pass
        # shed queued lease requests NOW: every parked owner re-picks a
        # node instead of waiting on a grant that will never come
        cfg = get_config()
        for req in list(self.lease_queue):
            self.lease_queue.remove(req)
            if not req.future.done():
                self._note_backpressure("draining")
                req.future.set_result(
                    {"backpressure": True,
                     "retry_after_s": cfg.lease_backpressure_retry_s})
        try:
            await asyncio.wait_for(
                self._drain_objects(deadline),
                max(0.05, deadline - time.monotonic()))
        except asyncio.TimeoutError:
            pass
        except Exception:
            pass
        # flush: an evict-triggered external spill may still be in flight
        # on the writer thread, and its owner registration only fires
        # after the write lands — exiting now would kill the sole copy
        # mid-upload (or leave it durable but unfindable)
        try:
            await asyncio.wait_for(
                self._flush_external_writes(deadline),
                max(0.05, deadline - time.monotonic()))
        except (asyncio.TimeoutError, Exception):
            pass
        # let outstanding leases return on their own, up to the deadline
        while (time.monotonic() < deadline
               and any(w.state == "LEASED" for w in self.workers.values())):
            await asyncio.sleep(0.05)
        await self._preempt_finish(graceful=True)

    async def _flush_external_writes(self, deadline: float):
        """Wait out in-flight external spill writes AND the pending
        owner-registration tasks they trigger (the write-done callback
        marshals the registration onto this loop via
        ``call_soon_threadsafe``, so one extra tick must pass before the
        ``_loc_updates`` task even exists)."""
        loop = asyncio.get_event_loop()
        for fut in list(self.store._ext_writes.values()):
            left = deadline - time.monotonic()
            if left <= 0:
                return
            try:
                await loop.run_in_executor(
                    None, lambda f=fut, t=left: f.result(max(0.1, t)))
            except Exception:
                pass
        await asyncio.sleep(0.05)  # let threadsafe-scheduled callbacks land
        for t in list(self._loc_updates.values()):
            left = deadline - time.monotonic()
            if left <= 0:
                return
            try:
                await asyncio.wait_for(asyncio.shield(t), left)
            except Exception:
                pass

    async def _drain_objects(self, deadline: float):
        """Re-home the owner-known sealed objects this node holds before
        it disappears — BOTH in-store entries and locally-spilled files (a
        local .spill file is just as much a sole copy as a shm entry):
        write-once to the external tier when configured (and register the
        URI with the owner as a non-node location), else replicate to a
        live peer.  Objects already on the external tier are skipped —
        they are durable already."""
        my_id = self.node_id.hex()
        peers = [v for nid, v in self.cluster_view.items()
                 if nid != my_id and v.alive
                 and not getattr(v, "draining", False)]
        loop = asyncio.get_event_loop()

        def _read_spill(path):
            with open(path, "rb") as f:
                return f.read()

        # Only OWNER-KNOWN objects re-home: an ownerless upload could never
        # be registered with anyone (undiscoverable) and nothing would
        # ever delete it — a permanent tier leak.  Ownership tracks
        # primariness by construction: task results / puts carry the owner
        # through store_create, while copies this node PULLED do not — so
        # the drain spends its notice window on the copies only this node
        # has, not on re-uploading a broadcast's replicas.
        victims = [(oid, e.owner, None)
                   for oid, e in list(self.store._entries.items())
                   if e.sealed and not e.freed and e.owner]
        victims += [(oid, self.store._spilled_owners[oid], path)
                    for oid, path in list(self.store._spilled.items())
                    if oid in self.store._spilled_owners]
        for oid, owner, spill_path in victims:
            if time.monotonic() >= deadline:
                return
            if oid in self.store._spilled_external:
                continue
            try:
                if spill_path is not None:
                    data = await loop.run_in_executor(None, _read_spill,
                                                      spill_path)
                else:
                    # [:size]: a seal-truncated entry's segment is the
                    # larger reservation; the tail is not data
                    ent = self.store._entries[oid]
                    data = bytes(ent.segment.view()[:ent.size])
            except Exception:
                continue
            if self.store.external_uri:
                uri = external_spill.object_uri(self.store.external_uri, oid)
                try:
                    await loop.run_in_executor(
                        None, external_spill.write, uri, data)
                except Exception:
                    continue
                self.store._spilled_external[oid] = uri
                self.store._ext_sizes[oid] = len(data)
                m = external_spill.spill_metrics()
                if m is not None:
                    m["bytes"].inc_key(external_spill.KEY_TIER_EXTERNAL,
                                       len(data))
                object_explain.ledger_record(object_explain.KEY_RE_HOME,
                                             len(data))
                self._obj_event(oid, object_explain.ObjectEvent.RE_HOMED,
                                to=uri, tier="external", size=len(data))
                if owner:
                    # awaited (not the background _location_update): the
                    # registration must land before this node dies or the
                    # copy is durable but unfindable
                    try:
                        await self.worker_clients.get(owner).call_retry(
                            "add_object_location", object_id=oid,
                            node_id=EXTERNAL_NODE_ID, address=uri,
                            _timeout=10.0)
                    except Exception:
                        pass
            else:
                # no external tier: replicate to the first peer that will
                # take it (one full/slow peer must not drop the rest of
                # the objects when others have room)
                for peer in peers:
                    if time.monotonic() >= deadline:
                        return
                    try:
                        await self.agent_clients.get(
                            peer.address).call_retry(
                            "store_put", object_id=oid, data=data,
                            owner=owner, _timeout=30.0)
                    except Exception:
                        continue
                    object_explain.ledger_record(
                        object_explain.KEY_RE_HOME, len(data))
                    self._obj_event(oid,
                                    object_explain.ObjectEvent.RE_HOMED,
                                    to=peer.address, tier="peer",
                                    size=len(data))
                    if owner:
                        try:
                            await self.worker_clients.get(
                                owner).call_retry(
                                "add_object_location", object_id=oid,
                                node_id=peer.node_id,
                                address=peer.address, _timeout=10.0)
                        except Exception:
                            pass
                    break

    async def _preempt_finish(self, graceful: bool):
        self._draining = True
        if graceful and self.gcs is not None:
            # deregister NOW: actors reschedule and the view stops routing
            # here immediately, instead of waiting out the health-check
            # threshold like an unannounced death
            try:
                await asyncio.wait_for(
                    self.gcs.call("drain_node", node_id=self.node_id.hex()),
                    5.0)
            except Exception:
                pass
        hook = self._on_preempt_exit
        if hook is not None:
            # standalone agent process: the whole "VM" disappears — take
            # the worker subprocesses down with it and exit hard, no
            # orderly unwind (that is what a preemption is)
            for w in list(self.workers.values()):
                if w.proc is not None:
                    try:
                        w.proc.kill()
                    except ProcessLookupError:
                        pass
            hook(graceful)
            return
        await self.stop()

    # --------------------------------------------------------------- actors

    async def handle_create_actor(self, spec: TaskSpec):
        """Lease a dedicated worker and run the actor-creation task on it
        (reference: GcsActorScheduler lease + PushTask of the creation task)."""
        # PG-placed actors lease out of the reserved bundle pool, NOT the free
        # pool — the bundle already holds those resources (prepare/commit), so
        # leasing from the free pool would double-count them.
        strategy = spec.scheduling_strategy
        bundle = None
        if (isinstance(strategy, (tuple, list)) and strategy
                and strategy[0] == "_pg"):
            bundle = (strategy[1], strategy[2])
        grant = await self.handle_request_worker_lease(
            resources=spec.resources, bundle=bundle,
            runtime_env=spec.runtime_env, allow_spillback=False)
        if "worker_address" not in grant:
            raise RuntimeError(f"cannot place actor here: {grant}")
        w = self.workers[grant["worker_id"]]
        w.is_actor = True
        w.actor_id = spec.actor_id.hex()
        client = self.worker_clients.get(grant["worker_address"])
        try:
            # Idempotent retry: a creation reply lost to a flaky link (a
            # chaos drop deterministically hits the FIRST reply of every
            # fresh worker for some seeds) replays from the worker's dedup
            # window instead of failing placement forever.
            await client.call_retry(
                "create_actor", spec=spec,
                _timeout=get_config().actor_creation_timeout_s)
        except Exception:
            await self._kill_worker_proc(w)
            self._release_lease_resources(grant["lease_id"])
            raise
        return {"worker_address": grant["worker_address"],
                "worker_id": grant["worker_id"]}

    # ------------------------------------------------------ placement bundles

    # Single-bundle RPCs: thin wrappers over the batched forms below so the
    # prepare/commit/return semantics live in exactly one place.

    async def handle_prepare_bundle(self, pg_id: str, bundle_index: int,
                                    resources: Dict[str, float]) -> bool:
        return await self.handle_prepare_bundles(
            pg_id, {bundle_index: resources})

    async def handle_commit_bundle(self, pg_id: str, bundle_index: int) -> bool:
        key = (pg_id, bundle_index)
        if key not in self.prepared_bundles and key in self.bundles:
            return True
        if key not in self.prepared_bundles:
            return False
        return await self.handle_commit_bundles(pg_id, [bundle_index])

    async def handle_return_bundle(self, pg_id: str, bundle_index: int) -> bool:
        return await self.handle_return_bundles(pg_id, [bundle_index])

    # Batched bundle RPCs: the GCS PG manager fans out ONE call per node
    # per phase (or a single fused call for single-node placements) instead
    # of one per bundle — the 2-phase protocol is unchanged, only the RPC
    # count drops (reference PrepareBundleResources batches the same way,
    # gcs_placement_group_scheduler.cc).

    def _acquire_all(self, pg_id: str,
                     bundles: Dict[int, Dict[str, float]]) -> bool:
        """All-or-nothing local prepare of several bundles."""
        taken = []
        for idx, resources in bundles.items():
            key = (pg_id, int(idx))
            if key in self.prepared_bundles or key in self.bundles:
                continue
            if not self.available.can_fit(resources):
                for k in taken:
                    self.available.release(self.prepared_bundles.pop(k).to_dict())
                return False
            self.available.acquire(resources)
            self.prepared_bundles[key] = ResourceSet(resources)
            taken.append(key)
        return True

    async def handle_prepare_bundles(self, pg_id: str,
                                     bundles: Dict[int, Dict[str, float]]) -> bool:
        return self._acquire_all(pg_id, bundles)

    async def handle_commit_bundles(self, pg_id: str, indices) -> bool:
        for idx in indices:
            key = (pg_id, int(idx))
            rs = self.prepared_bundles.pop(key, None)
            if rs is not None:
                self.bundles[key] = rs
        return True

    async def handle_prepare_commit_bundles(
            self, pg_id: str, bundles: Dict[int, Dict[str, float]]) -> bool:
        """Fused single-round-trip path: safe when the WHOLE placement is on
        this node (no cross-node atomicity to wait for)."""
        if not self._acquire_all(pg_id, bundles):
            return False
        for idx in bundles:
            key = (pg_id, int(idx))
            rs = self.prepared_bundles.pop(key, None)
            if rs is not None:
                self.bundles[key] = rs
        return True

    async def handle_return_bundles(self, pg_id: str, indices) -> bool:
        for idx in indices:
            key = (pg_id, int(idx))
            rs = (self.prepared_bundles.pop(key, None)
                  or self.bundles.pop(key, None))
            if rs is not None:
                self.available.release(rs.to_dict())
        await self._process_lease_queue()
        return True

    # ----------------------------------------------------------- object store

    async def handle_store_create(self, object_id: ObjectID, size: int,
                                  owner: Optional[str] = None):
        try:
            path = self.store.create(object_id, size, owner=owner)
        except ObjectStoreFullError as e:
            raise e
        return {"path": path}

    async def handle_store_seal(self, object_id: ObjectID,
                                size: Optional[int] = None):
        """``size`` (reserve-then-write puts): the exact byte count
        written — the entry truncates to it so the reservation's slack
        tail never serves, ships, or spills."""
        self.store.seal(object_id, truncate_to=size)
        return True

    async def handle_store_put(self, object_id: ObjectID, data: bytes,
                               owner: Optional[str] = None):
        self.store.create_and_write(object_id, data, owner=owner)
        return {"path": self.store.get_path(object_id)[0]}

    async def handle_store_get(self, object_id: ObjectID,
                               timeout: Optional[float] = 0.0):
        if self.store.external_only(object_id):
            res = await self._restore_external(object_id)
            if res is not None:
                return res
        if not self.store.contains(object_id):
            if not timeout:
                return None
            ok = await self.store.wait_sealed(object_id, timeout)
            if not ok:
                return None
        located = self.store.get_path(object_id)
        if located is None:
            return None  # freed-deferred (sealed but deleted) or evicted
        path, size = located
        return {"path": path, "size": size}

    async def handle_store_verify(self, object_id: ObjectID,
                                  path: str) -> bool:
        """Post-copy read validation for arena-backed objects: True iff the
        object is still sealed AT this path.  Runs on the agent loop — the
        same loop that evicts — so a True answer proves no evict+offset-reuse
        interleaved with the caller's copy (the file-per-object store never
        needed this: an unlinked file cannot alias a new object)."""
        e = self.store._entries.get(object_id)
        if e is not None and e.sealed and not e.freed \
                and e.segment.path == path:
            return True
        # Same-host proxy: the pin we hold on the source's real entry keeps
        # that slice from being evicted (and its offset from being reused)
        # for as long as the proxy exists, so presence-at-path IS validity.
        # A freed-deferred proxy fails verification: its slice outlives only
        # the current pin holders, not this caller's copy.
        p = self.store._proxies.get(object_id)
        if p is not None and not p.freed and p.path == path:
            return True
        # evicted-but-spilled (or restored elsewhere): not at `path` anymore
        return False

    async def handle_object_info(self, object_id: ObjectID):
        """Describe a sealed local object for a prospective puller: same-host
        pullers (matching host_key) zero-copy attach `path` instead of
        pulling bytes (see _pull_object).

        Answers from metadata only — a spilled entry returns None rather
        than being restored from disk just to satisfy a probe from a puller
        that may pick a different source (the byte-pull path restores on
        read_chunk when this node is actually chosen)."""
        # freed-deferred records are deleted, just not yet reclaimed: they
        # must be invisible to prospective pullers (same invariant as
        # contains/get_path/store_verify).
        e = self.store._entries.get(object_id)
        if e is not None and e.sealed and not e.freed:
            return {"path": e.segment.path, "size": e.size,
                    "host_key": self.host_key, "proxy": False}
        if (e is not None and not e.freed and e.avail
                and get_config().object_transfer_partial_serving):
            # in-progress pull publishing its chunk ledger: advertise the
            # held [start, end) ranges so other pullers stripe onto us
            # mid-broadcast.  Not zero-copy attachable (no pin on an
            # unsealed entry) — byte pulls only.
            return {"path": e.segment.path, "size": e.size,
                    "host_key": self.host_key, "proxy": False,
                    "partial": True,
                    "ranges": [list(r) for r in e.avail]}
        p = self.store._proxies.get(object_id)
        if p is not None and not p.freed:
            return {"path": p.path, "size": p.size,
                    "host_key": self.host_key, "proxy": True}
        return None

    async def handle_pin_object(self, object_id: ObjectID) -> bool:
        """Pin a REAL local entry for a same-host proxy holder (proxies can't
        be pinned — the second-level puller falls back to the true origin)."""
        e = self.store._entries.get(object_id)
        if e is None or not e.sealed or e.freed:
            return False
        self.store.pin(object_id)
        return True

    async def handle_unpin_object(self, object_id: ObjectID):
        await self._unpin_and_chain(object_id)

    async def handle_store_unpin_read(self, object_id: ObjectID,
                                      pinner: Optional[str] = None):
        """A consumer's last zero-copy view over ``object_id`` died: drop
        the read pin taken by ``fetch_object(pin=True)``.  May complete a
        deferred free — and for proxies, forward the release to the source
        agent whose slice backed the view.

        A release with no matching ledger record is STALE — the consumer's
        pins were already drained on its death/disconnect and this notify
        was in flight — and must be ignored, not applied: the store counter
        it would decrement now belongs to another consumer's pin."""
        if pinner:
            per = self._read_pins.get(pinner)
            kinds = per.get(object_id) if per is not None else None
            if not kinds:
                return True
            kind = next(iter(kinds))
            kinds[kind] -= 1
            if kinds[kind] <= 0:
                del kinds[kind]
            if not kinds:
                per.pop(object_id, None)
                self._pin_first_ts.pop((pinner, object_id), None)
                if not per:
                    self._read_pins.pop(pinner, None)
            await self._unpin_and_chain(object_id, kind)
        else:
            await self._unpin_and_chain(object_id)
        return True

    async def _pin_sweep_loop(self):
        """Liveness sweep for read-pin holders AND lease owners the worker
        monitor does not cover — chiefly the DRIVER, which is a consumer
        but not a spawned worker.  A consumer that vanishes without its
        exit drain (SIGKILL, preemption, or leases GC'd after the worker's
        shutdown flag suppressed the release notify) would otherwise leave
        its objects pinned — unevictable, frees deferred — for the agent's
        whole lifetime; a dead DRIVER's granted leases would pin this
        node's CPUs forever (the lease return is driver-side, and a
        SIGKILLed driver never sends it — a 2-CPU node fully leased to a
        dead driver can never schedule again).  Every consumer runs an RPC
        server with a ``ping`` handler, so a repeatedly unreachable
        address means the process is gone.  Acting on confirmed death
        only: a TIMEOUT means alive-but-busy, and a single connect failure
        can be transient (fd exhaustion, one dropped pooled connection) —
        releasing a LIVE consumer's pins would let the arena recycle
        slices under its views, so death takes three consecutive failed
        sweeps (~30 s) to declare."""
        strikes: Dict[str, int] = {}
        while not self._shutting_down:
            await asyncio.sleep(10.0)
            managed = {w.address for w in self.workers.values()}
            lease_owners = {w.owner for w in self.workers.values()
                            if w.state == "LEASED" and w.owner
                            and not w.is_actor}
            targets = {a for a in self._read_pins
                       if a not in managed} | lease_owners
            for addr in targets:
                try:
                    await asyncio.wait_for(
                        self.worker_clients.get(addr).call("ping"), 5.0)
                    strikes.pop(addr, None)
                except asyncio.TimeoutError:
                    continue
                except Exception:
                    # drop the pooled (possibly wedged) connection so the
                    # next strike probes with a fresh connect
                    await self.worker_clients.close(addr)
                    strikes[addr] = strikes.get(addr, 0) + 1
                    if strikes[addr] >= 3:
                        strikes.pop(addr, None)
                        if addr in self._read_pins:
                            await self._drain_read_pins(addr)
                        await self._reclaim_dead_owner_leases(addr)
            for a in list(strikes):
                if a not in self._read_pins and a not in lease_owners:
                    strikes.pop(a)

    async def _reclaim_dead_owner_leases(self, owner: str):
        """A lease owner is confirmed dead: kill its leased task workers
        (their results have nowhere to go — the work is orphaned) so the
        lease resources return to the pool.  Actor workers are spared:
        actor lifetime is GCS-managed (job GC / max_restarts), not tied to
        the submitting owner's process."""
        for w in list(self.workers.values()):
            if w.state == "LEASED" and w.owner == owner and not w.is_actor:
                try:
                    print(f"[node-agent] reclaiming lease {w.lease_id} of "
                          f"dead owner {owner}", flush=True)
                except Exception:
                    pass
                await self._kill_worker_proc(w)

    async def _drain_read_pins(self, consumer_addr: Optional[str]):
        """Release every read pin a dead consumer still held (the plasma
        disconnect-releases-pins contract); completes deferred frees."""
        if not consumer_addr:
            return
        for oid, kinds in self._read_pins.pop(consumer_addr, {}).items():
            self._pin_first_ts.pop((consumer_addr, oid), None)
            for kind, count in kinds.items():
                for _ in range(count):
                    await self._unpin_and_chain(oid, kind)

    async def _unpin_and_chain(self, object_id: ObjectID,
                               kind: Optional[str] = None):
        await self._notify_source_unpin(self.store.unpin(object_id, kind),
                                        object_id)

    async def _notify_source_unpin(self, source: Optional[str],
                                   object_id: ObjectID):
        """A completed free of a same-host proxy returns the SOURCE agent's
        address: release the transfer pin we hold on its real entry so the
        origin slice becomes evictable again."""
        if not source:
            return
        try:
            await self.agent_clients.get(source).notify(
                "unpin_object", object_id=object_id)
        except Exception:
            pass

    async def handle_store_free(self, object_ids: List[ObjectID]):
        for oid in object_ids:
            await self._notify_source_unpin(self.store.free(oid), oid)
        return True

    async def handle_store_contains(self, object_id: ObjectID) -> bool:
        return self.store.contains(object_id)

    async def handle_store_stats(self):
        return self.store.stats()

    async def handle_store_objects(self):
        """Per-object refcount/size/location rows for ``raytpu memory``."""
        rows = self.store.objects()
        for r in rows:
            r["node_id"] = self.node_id.hex()
        return rows

    # -------------------------------------- object-plane flight recorder

    def _buffer_object_event(self, object_id: ObjectID, event: str,
                             detail: dict):
        """Store-hook target + agent-originated stamp point: one bounded
        append per lifecycle transition; the flush loop ships batches to
        the GCS object-event ring.  Callers (the store's ``_event`` and
        ``_obj_event`` below) already checked the kill switch."""
        if len(self._object_events) >= 10_000:
            self._object_events_dropped += 1
            return
        self._object_events.append({
            "object_id": object_id.hex(), "event": event,
            "ts": time.time(), "node": self.node_id.hex()[:12], **detail})

    def _obj_event(self, object_id: ObjectID, event: str, **detail):
        """Agent-side transition stamp (pull landings, proxy attaches,
        re-homes, pin grants) — same trail as the store's transitions."""
        if not object_explain.enabled():
            return
        self._buffer_object_event(object_id, event, detail)

    async def _flush_object_events_loop(self):
        while not self._shutting_down:
            await asyncio.sleep(1.0)
            if not self._object_events or self.gcs is None:
                continue
            batch, self._object_events = self._object_events, []
            dropped, self._object_events_dropped = \
                self._object_events_dropped, 0
            try:
                await self.gcs.call_retry("add_object_events",
                                          events=batch, dropped=dropped)
            except Exception:
                pass

    def _record_transfer(self, object_id: ObjectID, size: int, kind: str,
                         t0: float, status: str, source: str = "",
                         stats: Optional[dict] = None):
        """Append one completed/failed pull's end-state to the bounded
        per-agent flight-recorder ring (``state.transfers()``)."""
        if not object_explain.enabled():
            return
        rec = {"object_id": object_id.hex(), "bytes": size, "kind": kind,
               "status": status, "node": self.node_id.hex()[:12],
               "ts": t0, "duration_s": round(time.time() - t0, 6)}
        if source:
            rec["source"] = source
        if stats:
            rec.update(stats)
        self._transfer_ring.append(rec)

    async def handle_transfers(self, limit: int = 100):
        """Tail of this agent's per-pull flight-recorder ring, newest
        first: per-source bytes/chunks/failures, steals, retries, relay
        fraction — the post-hoc answer to "how did this object get
        here"."""
        out = []
        for rec in reversed(self._transfer_ring):
            out.append(rec)
            if len(out) >= max(1, limit):
                break
        return out

    def _leak_suspects_cheap(self, ttl_s: float, now: float) -> list:
        """The probe-free half of the leak report (also sampled into
        ``raytpu_mem_leak_suspects``): read pins held past the TTL by
        consumers the liveness sweep still believes alive, and deferred
        frees stuck behind pins no ledger entry accounts for (the holder
        vanished without a drain — nothing will ever complete the free)."""
        leaks = []
        for (pinner, oid), t0 in list(self._pin_first_ts.items()):
            age = now - t0
            if age < ttl_s:
                continue
            kinds = self._read_pins.get(pinner, {}).get(oid, {})
            leaks.append({"kind": "pin_ttl", "object_id": oid.hex(),
                          "holder": pinner, "age_s": round(age, 1),
                          "pins": sum(kinds.values())})
        # ledger-accounted pin totals per object (read pins only; an
        # in-flight pull legitimately holds an unledgered transfer pin)
        accounted: Dict[ObjectID, int] = {}
        for per in self._read_pins.values():
            for oid, kinds in per.items():
                accounted[oid] = accounted.get(oid, 0) + sum(kinds.values())
        for oid, e in list(self.store._entries.items()):
            if not e.freed or e.pinned <= 0:
                continue
            if oid in self._inflight_pulls:
                continue  # transfer pin: the pull's unpin completes it
            if accounted.get(oid, 0) < e.pinned:
                leaks.append({
                    "kind": "vanished_pin", "object_id": oid.hex(),
                    "pins": e.pinned, "accounted": accounted.get(oid, 0),
                    "age_s": round(time.monotonic() - e.last_access, 1),
                    "size": e.size})
        return leaks

    async def handle_store_leaks(self, pin_ttl_s: Optional[float] = None):
        """Ref-debt / leak report for this node (``raytpu memory
        --leaks``): pin-TTL and vanished-pin suspects from the cheap
        sweep, plus sole-copy entries whose OWNER process no longer
        answers a ping — durable bytes no reachable borrower can ever
        free (the owner-side refcount died with the owner)."""
        ttl = pin_ttl_s if pin_ttl_s is not None \
            else get_config().object_pin_leak_ttl_s
        leaks = self._leak_suspects_cheap(ttl, time.time())
        # owner-lost probe: one concurrent short ping per distinct owner
        owners: Dict[str, List[ObjectID]] = {}
        for oid, e in list(self.store._entries.items()):
            if e.sealed and not e.freed and e.owner:
                owners.setdefault(e.owner, []).append(oid)

        async def _probe(addr):
            try:
                await asyncio.wait_for(
                    self.worker_clients.get(addr).call("ping"), 2.0)
                return addr, True
            except asyncio.TimeoutError:
                return addr, True  # alive-but-busy is not owner loss
            except Exception:
                return addr, False

        for addr, alive in await asyncio.gather(
                *(_probe(a) for a in owners)):
            if alive:
                continue
            for oid in owners[addr]:
                e = self.store._entries.get(oid)
                if e is None:
                    continue
                leaks.append({"kind": "owner_lost", "object_id": oid.hex(),
                              "owner": addr, "size": e.size,
                              "pins": e.pinned})
        for rec in leaks:
            rec["node"] = self.node_id.hex()[:12]
        return leaks

    # -------------------------------------------------------- object transfer

    async def handle_read_chunk(self, object_id: ObjectID, offset: int,
                                length: int, with_crc: bool = False):
        """Serve a chunk of a local object to a remote agent (reference:
        chunked object push/pull, object_manager.proto:61).  Serves sealed
        entries, same-host proxies, and the SEALED RANGES of an in-progress
        pull (partial-object serving — the chunk ledger publishes each
        landed chunk, so this node relays a broadcast after one chunk-time;
        an uncovered range raises a typed ChunkNotAvailable the puller
        re-stripes).

        SENDER-SIDE ZERO-COPY: the reply carries a memoryview straight
        over the shm mapping — no intermediate ``bytes`` slice on this
        side (the hot-path lint pins that).  This is safe on
        interpreters whose transport write() CONSUMES the buffer before
        returning (<= 3.11: the selector transport sends what it can and
        copies the remainder into its own bytearray): the dispatch
        writes the reply synchronously after the handler returns,
        vectored frames flush immediately, and eviction/free run on this
        same loop, so no arena recycle can interleave.  On 3.12+ the
        transport RETAINS caller buffers across loop ticks
        (zero-copy write queue), so the view is defensively materialized
        by ``_owned_reply_buffer`` — a dangling view over a recycled
        arena range would otherwise ship another object's bytes.  No
        ``await`` may be added between the view read and the handler's
        return.

        ``with_crc`` adds a per-chunk checksum (native CRC-32C / zlib) the
        puller verifies before marking the chunk landed."""
        import pickle as _pickle
        if self.store.external_only(object_id):
            # a stale location routed a puller here after we evicted to the
            # external tier: restore off-loop first, never inline on the
            # serving loop
            await self._restore_external(object_id)
        view = _owned_reply_buffer(
            self.store.read_chunk_view(object_id, offset, length))
        m = transfer_metrics()
        if m is not None:
            m["bytes"].inc_key(KEY_CHUNK_OUT, view.nbytes)
        if with_crc:
            crc, algo = chunk_checksum(view)
            return {"crc": crc, "algo": algo,
                    "data": _pickle.PickleBuffer(view)}
        return _pickle.PickleBuffer(view)

    # -- bulk transfer channel (core/bulk_transfer.py) --------------------

    async def handle_bulk_info(self):
        """The bulk transfer channel's address on this node (None when the
        channel failed to start — peers keep the RPC chunk path)."""
        if self._bulk_server is None:
            return {"address": None}
        return {"address": f"{self.server.host}:{self._bulk_server.port}"}

    async def _bulk_acquire(self, object_id: ObjectID, offset: int,
                            length: int):
        """Runs on the agent loop for a bulk serving THREAD: resolve a
        pinned view like handle_read_chunk, but pin-protected — the
        thread pushes the view into the kernel outside this loop, so the
        same-tick no-recycle argument does not apply; the pin makes
        eviction skip the record and defers frees instead.

        -> (view, kind, full): sealed entries/proxies grant the WHOLE
        object (full=True) so the serving connection caches ONE pinned
        grant per object instead of marshalling onto this loop per chunk;
        partial holders grant per-chunk (their covered ranges change
        every chunk-time)."""
        if self.store.external_only(object_id):
            await self._restore_external(object_id)
        e = self.store._entries.get(object_id)
        full = (e is not None and e.sealed and not e.freed) or (
            e is None and object_id in self.store._proxies)
        if full:
            size = (e.size if e is not None
                    else self.store._proxies[object_id].size)
            view = self.store.read_chunk_view(object_id, 0, size)
        else:
            view = self.store.read_chunk_view(object_id, offset, length)
        kind = self.store.pin_for_serve(object_id)
        return view, kind, full

    async def _bulk_release(self, object_id: ObjectID,
                            kind: Optional[str]):
        if kind is not None:
            await self._unpin_and_chain(object_id, kind)

    def _transfer_executor(self):
        if self._transfer_pool is None:
            import concurrent.futures
            self._transfer_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(4,
                                get_config().object_transfer_parallelism),
                thread_name_prefix="bulk-land")
        return self._transfer_pool

    def _get_bulk_pool(self):
        if self._bulk_pool is None:
            from .bulk_transfer import BulkPool
            self._bulk_pool = BulkPool()
        return self._bulk_pool

    def _bulk_addr_for(self, addr: str) -> Optional[str]:
        """The peer's bulk-channel address, cached per agent.  Unknown
        peers kick ONE background resolution (``bulk_info`` RPC) and the
        caller uses the asyncio chunk path meanwhile — the next chunk
        rides the bulk channel."""
        cached = self._bulk_addrs.get(addr, "unresolved")
        if isinstance(cached, str) and cached != "unresolved":
            return cached
        if cached != "unresolved":
            return None  # in flight (None) or peer has none (False)
        self._bulk_addrs[addr] = None

        async def _resolve():
            try:
                info = await self.agent_clients.get(addr).call(
                    "bulk_info", _timeout=5.0)
                self._bulk_addrs[addr] = info.get("address") or False
            except Exception:
                self._bulk_addrs.pop(addr, None)  # retry on a later chunk

        t = asyncio.ensure_future(_resolve())
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return None

    async def _bulk_fetch_chunk(self, object_id: ObjectID, addr: str,
                                bulk_addr: str, stripe: int,
                                sink: memoryview, off: int, n: int,
                                with_crc: bool, timeout_s: float) -> int:
        """Run one bulk fetch on the landing executor.  The finally block
        restores the no-late-write guarantee the asyncio path gets from
        call_into: if this coroutine is cancelled or times out while the
        executor thread is still landing into ``sink``, the socket is
        killed and the thread WAITED OUT before control returns — the
        caller may recycle the arena range behind ``sink`` right after."""
        import concurrent.futures
        pool = self._get_bulk_pool()
        cfut = self._transfer_executor().submit(
            pool.fetch, addr, bulk_addr, stripe, object_id, off, n, sink,
            with_crc, timeout_s)
        try:
            return await asyncio.wait_for(asyncio.wrap_future(cfut),
                                          timeout_s + 5.0)
        finally:
            # the guarantee must actually HOLD, not be attempted once: a
            # thread still inside create_connection registers its socket
            # only after connecting (one drop would miss it), so drop
            # again each round until the future is genuinely done — with
            # the socket dead, recv/sendall fail within one syscall,
            # bounding the loop to the connect timeout.  Only THIS
            # stripe's socket dies: the other stripes' healthy in-flight
            # fetches from the same source must not become collateral.
            while not cfut.done():
                pool.drop_stripe(bulk_addr, stripe)
                await asyncio.get_event_loop().run_in_executor(
                    None, lambda: concurrent.futures.wait([cfut], 5.0))

    async def handle_fetch_object(self, object_id: ObjectID, size: int,
                                  locations: List[Tuple[str, str]],
                                  owner: Optional[str] = None,
                                  pin: bool = False,
                                  pinner: Optional[str] = None):
        """Ensure `object_id` is in the local store, pulling from a remote node
        if needed. Returns {path, size, pinned} (reference: PullManager
        admission-controlled prioritized pulls + PushManager chunked
        transfer).

        ``pin=True`` atomically pins the located object for the caller
        before replying (no await between locate and pin, and this loop is
        the only evictor — so a ``pinned: True`` reply guarantees the path
        stays valid until the caller's ``store_unpin_read``).  Followers of
        a deduped pull pin independently: the shared in-flight future
        carries only {path, size}.

        Broadcast shape: the source location is picked at RANDOM from the
        owner's list, and a completed pull REPORTS this node back to the
        owner — so an N-node broadcast fans out over a doubling set of
        sources (tree propagation) instead of hammering the origin."""
        res = await self._locate_or_pull(object_id, size, locations, owner)
        res = dict(res)
        # A pin needs a ledger entry or it can never be drained: grant only
        # when the caller identifies itself.
        kind = self.store.pin_for_read(object_id) if (pin and pinner) else None
        res["pinned"] = kind is not None
        if kind and pinner:
            kinds = self._read_pins.setdefault(pinner, {}).setdefault(
                object_id, {})
            first = not kinds
            kinds[kind] = kinds.get(kind, 0) + 1
            if first:
                # transitions-only stamping: this consumer's FIRST pin on
                # the object (further pins on the same grant are silent);
                # the timestamp feeds the pin-TTL leak detector
                self._pin_first_ts.setdefault((pinner, object_id),
                                              time.time())
                self._obj_event(object_id, object_explain.ObjectEvent.PINNED,
                                holder=pinner)
        return res

    async def _locate_or_pull(self, object_id: ObjectID, size: int,
                              locations: List[Tuple[str, str]],
                              owner: Optional[str]):
        if self.store.external_only(object_id):
            res = await self._restore_external(object_id)
            if res is not None:
                return res
        if self.store.contains(object_id):
            located = self.store.get_path(object_id)
            # None: the only copy is an external record whose restore just
            # failed (transient tier error) — fall through to the pull
            # path, which can stripe over the URI and other holders
            if located is not None:
                path, sz = located
                return {"path": path, "size": sz}
        e = self.store._entries.get(object_id)
        if e is not None and not e.freed:
            # Created locally but not sealed yet: the writer's one-way seal
            # (or its in-progress copy) is still in flight — park on it
            # rather than treating a local object as remote.  (A freed-
            # deferred entry is sealed but DELETED: fall through to the
            # remote pull instead of serving it.)
            if await self.store.wait_sealed(object_id, 30.0):
                located = self.store.get_path(object_id)
                if located is not None:
                    path, sz = located
                    return {"path": path, "size": sz}
        # Dedup concurrent pulls of the same object: followers await the
        # leader's transfer instead of pulling a second copy.
        inflight = self._inflight_pulls.get(object_id)
        if inflight is not None:
            return dict(await asyncio.shield(inflight))
        fut = asyncio.get_event_loop().create_future()
        self._inflight_pulls[object_id] = fut
        try:
            res = await self._pull_object(object_id, size, locations, owner)
            if not fut.done():
                fut.set_result(res)
            return res
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
            fut.exception()  # mark retrieved for followers that never await
            raise
        finally:
            self._inflight_pulls.pop(object_id, None)

    async def _restore_external(self, object_id: ObjectID) -> Optional[dict]:
        """Restore an external-tier-only object into the local store with
        the network read OFF-LOOP (a gs:// download must not freeze
        heartbeats/lease grants for its duration — the store's synchronous
        ``_maybe_restore`` stays only as the local-disk / direct-store
        path).  Deduped through its own in-flight map so concurrent
        readers share ONE external fetch; the shared future resolves to
        the result dict OR None — never an exception — so followers fall
        back to the normal locate/pull paths exactly like the leader
        (``_inflight_pulls`` futures stay dict-only; mixing the two maps
        would hand a follower None where it expects a dict)."""
        inflight = self._inflight_restores.get(object_id)
        if inflight is not None:
            return await asyncio.shield(inflight)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._inflight_restores[object_id] = fut
        res: Optional[dict] = None
        try:
            uri = self.store._spilled_external.get(object_id)
            if uri is not None:
                wfut = self.store._ext_writes.get(object_id)
                if wfut is not None:
                    # reader raced the spill write: wait it out off-loop
                    await loop.run_in_executor(None,
                                               lambda: wfut.result(60.0))
                data = await loop.run_in_executor(
                    None, external_spill.timed_read, uri)
                self.store.restore_external_bytes(object_id, data)
                located = self.store.get_path(object_id)
                if located is not None:
                    res = {"path": located[0], "size": located[1]}
        except asyncio.CancelledError:
            raise
        except Exception:      # leader AND followers fall back to the
            res = None         # normal locate/pull paths
            # and the store's SYNC fallback must not re-attempt the read
            # on the event loop right after this off-loop one failed
            self.store._ext_backoff[object_id] = time.monotonic() + 5.0
        finally:
            if not fut.done():
                fut.set_result(res)
            self._inflight_restores.pop(object_id, None)
        return res

    @property
    def _inflight_restores(self) -> Dict[ObjectID, "asyncio.Future"]:
        if not hasattr(self, "_inflight_restores_map"):
            self._inflight_restores_map: Dict[ObjectID, "asyncio.Future"] = {}
        return self._inflight_restores_map

    def _trace_transfer(self, **ev):
        """Opt-in per-transfer timeline (RAYTPU_TRANSFER_TRACE_DIR): one
        JSONL per agent recording every chunk pull / zero-copy attach with
        wall-clock start/end — the artifact that shows where broadcast
        overlap lives (or dies) on a given box."""
        d = os.environ.get("RAYTPU_TRANSFER_TRACE_DIR")
        if not d:
            return
        try:
            import json as _json
            with open(os.path.join(d, f"transfer-{os.getpid()}.jsonl"),
                      "a") as f:
                f.write(_json.dumps(
                    {"node": self.node_id.hex()[:12], **ev}) + "\n")
        except Exception:
            pass

    async def _pull_object(self, object_id: ObjectID, size: int,
                           locations: List[Tuple[str, str]],
                           owner: Optional[str]):
        import random
        async with self._pull_sem:
            if self.store.contains(object_id):
                located = self.store.get_path(object_id)
                if located is not None:
                    path, sz = located
                    return {"path": path, "size": sz}
                # external-only record whose restore failed: pull instead
            cfg = get_config()
            # External-tier URIs ("external" locations, e.g. a gs://
            # object the spilling node registered before dying) are valid
            # CHUNK sources for the striped pull, but not RPC endpoints:
            # keep them out of the zero-copy probe loop.
            ext_sources = [addr for _nid, addr in locations
                           if is_external_address(addr)]
            candidates = [(nid, addr) for nid, addr in locations
                          if addr != self.server.address
                          and not is_external_address(addr)]
            random.shuffle(candidates)
            # Same-host fast path: attach the source's pool slice instead of
            # copying bytes through a socket — the source pins the object for
            # us until we free our proxy (zero-copy same-host broadcast).
            # RAYTPU_DISABLE_ZERO_COPY=1 forces the chunked byte path — the
            # bench/test seam for exercising what distinct hosts do.
            if os.environ.get("RAYTPU_DISABLE_ZERO_COPY") == "1":
                candidates_zc = []
            else:
                candidates_zc = candidates
            for node_id, addr in candidates_zc:
                client = self.agent_clients.get(addr)
                try:
                    info = await client.call("object_info",
                                             object_id=object_id)
                except Exception:
                    continue
                if (not info or info.get("proxy") or info.get("partial")
                        or info.get("host_key") != self.host_key):
                    # partial holders can't grant a pin (unsealed entry):
                    # byte pulls may stripe onto them, attaches may not
                    continue
                try:
                    t_pin = time.time()
                    if await client.call("pin_object", object_id=object_id):
                        self.store.add_proxy(object_id, info["path"],
                                             info["size"], addr)
                        m = transfer_metrics()
                        if m is not None:
                            m["bytes"].inc_key(KEY_PROXY_IN, info["size"])
                        object_explain.ledger_record(
                            object_explain.KEY_TRANSFER_PROXY, info["size"])
                        self._obj_event(
                            object_id,
                            object_explain.ObjectEvent.TRANSFERRED,
                            source=addr, size=info["size"], zero_copy=True)
                        self._record_transfer(
                            object_id, info["size"], "proxy", t_pin, "ok",
                            source=addr)
                        self._trace_transfer(
                            kind="proxy_attach", object=object_id.hex()[:12],
                            source=addr, bytes=info["size"],
                            t0=t_pin, t1=time.time())
                        if owner:
                            # A proxy holder IS a source for byte pullers
                            # (read_chunk attaches the proxied slice);
                            # same-host pullers skip it via
                            # object_info.proxy and go to the origin (no
                            # proxy-of-proxy pin chains).
                            self._register_object_location(owner, object_id)
                        return {"path": info["path"], "size": info["size"]}
                except Exception:
                    continue
            return await self._pull_object_chunks(
                object_id, size,
                [addr for _nid, addr in candidates] + ext_sources,
                owner, cfg)

    def _register_object_location(self, owner: str, object_id: ObjectID):
        """Tell the owner this node now holds (part of) the object.

        Retried with an idempotency token (``call_retry``): the old
        fire-and-forget notify meant one dropped frame permanently hid this
        source from the owner's location view.  Runs as a background task —
        the pull's caller shouldn't wait out a retry backoff — with a
        strong ref so the loop can't GC it mid-flight."""
        self._location_update(owner, "add_object_location", object_id)

    def _deregister_object_location(self, owner: str, object_id: ObjectID):
        """Withdraw an early (partial) registration after a FAILED pull:
        the owner's location list must not keep routing pullers at a node
        that freed the segment."""
        self._location_update(owner, "remove_object_location", object_id)

    def _location_update(self, owner: str, method: str,
                         object_id: ObjectID,
                         node_id: Optional[str] = None,
                         address: Optional[str] = None):
        """Background location add/remove, SEQUENCED per (owner, object):
        updates for one object chain behind each other, so a failed pull's
        remove can never overtake its own still-retrying add (unordered
        tasks could re-register a freed segment forever).

        ``node_id``/``address`` default to THIS node; the external-spill
        hook passes ``(EXTERNAL_NODE_ID, uri)`` to register a copy that is
        not on any node."""
        key = (owner, object_id)
        prev = self._loc_updates.get(key)
        loc_node = node_id if node_id is not None else self.node_id.hex()
        loc_addr = address if address is not None else self.server.address

        async def _send():
            if prev is not None:
                try:
                    await asyncio.shield(prev)
                except Exception:
                    pass
            try:
                await self.worker_clients.get(owner).call_retry(
                    method, object_id=object_id,
                    node_id=loc_node,
                    address=loc_addr, _timeout=15.0)
            except Exception:
                pass

        t = asyncio.ensure_future(_send())
        self._loc_updates[key] = t
        self._bg_tasks.add(t)

        def _done(task, _key=key):
            self._bg_tasks.discard(task)
            if self._loc_updates.get(_key) is task:
                del self._loc_updates[_key]

        t.add_done_callback(_done)

    async def _pull_object_chunks(self, object_id: ObjectID, size: int,
                                  sources: List[str], owner: Optional[str],
                                  cfg) -> dict:
        """Chunk-ledger striped byte pull (the cross-host broadcast path).

        Chunks are scheduled across ALL known sources concurrently
        (per-source windows, work-stealing of slow chunks, chunk-granular
        retry on another source), every landed chunk is published so this
        node relays the broadcast while still pulling, and the owner's
        location view is re-polled mid-pull to fold in new sources.  See
        ``core/transfer.py`` for the engine."""
        if not sources and not owner:
            raise RuntimeError(
                f"failed to fetch {object_id}: no locations and no owner")
        import random as _random
        self.store.create(object_id, size)
        # Transfer pin for the pull's whole duration: partial serving
        # registers this node with the owner after the FIRST chunk, so an
        # owner-side free can now arrive MID-PULL — unpinned, it would
        # complete immediately and recycle the arena range under the
        # in-flight chunk landings (create+pin run in one loop tick, so
        # the free cannot slip between them).  Pinned, the free defers;
        # the unpin below completes it and the pull reports "vanished".
        self.store.pin(object_id)
        seg = self.store._entries[object_id].segment
        # per-puller permuted claim order (rarest-first in spirit): the
        # pullers of one broadcast land COMPLEMENTARY ranges, so partial
        # serving actually relays — in lockstep 0..N order every peer only
        # ever holds the prefix the others already have
        n_chunks = max(1, -(-size // cfg.object_transfer_chunk_bytes))
        order = list(range(n_chunks))
        _random.shuffle(order)
        ledger = ChunkLedger(size, cfg.object_transfer_chunk_bytes,
                             order=order)
        partial = cfg.object_transfer_partial_serving
        registered = False
        # wire-rate knobs: parallel sockets per source (sticky per chunk)
        # and adaptive per-request growth in base-chunk runs
        sock_n = max(1, cfg.transfer_sockets_per_source)
        run_max = max(1, cfg.object_transfer_chunk_max
                      // max(1, cfg.object_transfer_chunk_bytes))
        sock_rr: Dict[str, int] = {}
        chunk_subs: Dict[int, int] = {}

        def clamp_run_chunks() -> int:
            # receiver-side re-clamp: a grown request must never exceed
            # the largest free arena block of THIS (receiving) store —
            # any transfer-plane landing that needs a contiguous arena
            # range (checksum scratch, restore) must fit without forcing
            # an eviction/spill mid-pull
            pool = self.store.pool
            if pool is None:
                return run_max
            try:
                lf = pool.largest_free
            except Exception:
                return 1
            return max(1, lf // max(1, cfg.object_transfer_chunk_bytes))

        def on_chunk(i, off, n, addr, t0, t1, stolen):
            nonlocal registered
            if partial:
                # publish the landed range BEFORE registering as a source:
                # a puller that finds us must find bytes
                self.store.mark_available(object_id, off, n)
            self._trace_transfer(
                kind="chunk", object=object_id.hex()[:12], source=addr,
                offset=off, bytes=n, t0=t0, t1=t1, stolen=stolen,
                socket=chunk_subs.pop(off, 0))
            if partial and not registered and owner:
                registered = True
                self._register_object_location(owner, object_id)

        async def fetch_chunk(addr, off, n):
            # sock_n == 1 keeps the historical single shared connection
            # (stripe 0); > 1 spreads chunks sticky over DEDICATED bulk
            # stripes 1..sock_n (big socket buffers, large reads) so
            # multi-MB replies stream concurrently instead of serializing
            # head-of-line with each other and the control traffic
            sub = 0
            if sock_n > 1 and not is_external_address(addr):
                sub = 1 + (sock_rr.get(addr, -1) + 1) % sock_n
                sock_rr[addr] = sock_rr.get(addr, -1) + 1
            chunk_subs[off] = sub
            return await self._fetch_chunk(object_id, seg, addr, off, n,
                                           cfg, sub)

        async def probe_source(addr):
            if is_external_address(addr):
                # external copies are complete by construction (the spill
                # write is atomic: tmp-file rename / single upload)
                ok = await asyncio.get_event_loop().run_in_executor(
                    None, external_spill.exists, addr)
                return {"full": True} if ok else None
            try:
                info = await self.agent_clients.get(addr).call(
                    "object_info", object_id=object_id, _timeout=5.0)
            except Exception:
                return None
            if not info:
                return None
            if info.get("partial"):
                return {"full": False, "ranges": info.get("ranges") or []}
            return {"full": True}

        async def refresh_sources():
            rec = await self.worker_clients.get(owner).call(
                "locate_object", object_id=object_id, timeout=0,
                _timeout=5.0)
            if rec and rec[0] == "plasma":
                return [addr for _nid, addr in rec[2]
                        if addr != self.server.address]
            return []

        puller = StripedPull(
            ledger, fetch_chunk=fetch_chunk, probe_source=probe_source,
            refresh_sources=refresh_sources if owner else None,
            on_chunk=on_chunk,
            per_source_window=cfg.object_transfer_per_source_window,
            total_window=cfg.object_transfer_parallelism,
            steal_after_s=cfg.object_transfer_steal_after_s,
            max_source_failures=cfg.object_transfer_max_source_failures,
            refresh_period_s=cfg.object_transfer_source_refresh_s,
            stall_timeout_s=cfg.object_transfer_stall_timeout_s,
            run_max_chunks=run_max,
            clamp_run_chunks=clamp_run_chunks if run_max > 1 else None)
        t_pull = time.time()
        try:
            try:
                stats = await puller.run(sources)
            except asyncio.CancelledError:
                # engine teardown already awaited every in-flight landing,
                # so freeing the segment cannot race a late chunk write
                if registered and owner:
                    self._deregister_object_location(owner, object_id)
                self._record_transfer(object_id, size, "chunked", t_pull,
                                      "cancelled")
                self.store.free(object_id)  # defers under our pin
                raise
            except BaseException as e:  # noqa: BLE001
                if registered and owner:
                    # withdraw the early partial registration — the owner
                    # must not keep routing pullers at a freed segment
                    self._deregister_object_location(owner, object_id)
                self._record_transfer(object_id, size, "chunked", t_pull,
                                      "failed")
                self.store.free(object_id)  # defers under our pin
                raise RuntimeError(
                    f"failed to fetch {object_id} from {sources}: {e}"
                ) from e
            self.store.seal(object_id)
        finally:
            # releases the transfer pin; completes any free deferred
            # during the pull (our own failure free above, or an
            # owner-side free that raced the broadcast)
            self.store.unpin(object_id)
        object_explain.ledger_record(object_explain.KEY_TRANSFER_LAND, size)
        self._obj_event(object_id, object_explain.ObjectEvent.TRANSFERRED,
                        size=size, sources=stats.get("sources_used"),
                        chunks=stats.get("chunks_done"))
        self._record_transfer(object_id, size, "chunked", t_pull, "ok",
                              stats=stats)
        self._trace_transfer(
            kind="pull_summary", object=object_id.hex()[:12], bytes=size,
            t0=t_pull, t1=time.time(), sockets_per_source=sock_n,
            chunk_max_bytes=run_max * cfg.object_transfer_chunk_bytes,
            **stats)
        if owner:
            self._register_object_location(owner, object_id)
        located = self.store.get_path(object_id)
        if located is None:
            # owner freed it mid-pull (the deferred free completed on our
            # unpin): the object is gone — report it, never serve it
            raise RuntimeError(f"object {object_id} vanished during pull")
        path, sz = located
        return {"path": path, "size": sz}

    async def _fetch_chunk(self, object_id: ObjectID, seg, addr: str,
                           off: int, n: int, cfg, sub: int = 0) -> int:
        """Land one chunk (or a grown run of base chunks) from ``addr``
        into the destination segment.

        The reply's out-of-band buffer lands DIRECTLY into the segment
        view (``call_into`` readinto-style receive) — no intermediate
        ``bytes``, no slice-assign: zero extra copies on this side beyond
        the socket read itself.  ``sub`` picks the parallel transfer
        socket to ``addr`` (sticky per chunk; see
        ``transfer_sockets_per_source``).  Returns the byte count landed;
        the engine rejects short chunks (a truncated reply must never
        seal a corrupt object)."""
        sink = seg.view()[off:off + n]
        if is_external_address(addr):
            # external-tier chunk source: range-read the URI off-loop and
            # land it like any other chunk — the ledger's short-chunk /
            # retry / source-death handling applies unchanged
            data = await asyncio.get_event_loop().run_in_executor(
                None, external_spill.read_range, addr, off, n)
            landed = len(data)
            if landed <= n:
                sink[:landed] = data
            return landed
        # a grown run carries proportionally more bytes than the base
        # chunk the timeout was tuned for: scale it, bounded
        timeout_s = min(
            cfg.object_transfer_chunk_timeout_s
            * max(1, -(-n // max(1, cfg.object_transfer_chunk_bytes))),
            max(cfg.object_transfer_chunk_timeout_s,
                cfg.object_transfer_stall_timeout_s * 2))
        with_crc = cfg.object_transfer_checksum
        if sub > 0:
            # multi-socket mode: ride the threaded bulk channel when the
            # peer advertises one (sendall/recv_into straight between shm
            # mappings and the kernel, GIL released — the asyncio RPC
            # path below stays as the fallback and the sockets=1 arm)
            bulk_addr = self._bulk_addr_for(addr)
            if bulk_addr:
                try:
                    return await self._bulk_fetch_chunk(
                        object_id, addr, bulk_addr, sub - 1, sink, off, n,
                        with_crc, timeout_s)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    # the peer may have restarted with a NEW bulk port at
                    # the same RPC address: drop the cached bulk address
                    # so the next chunk re-resolves (riding the RPC path
                    # meanwhile) instead of permanently hammering a dead
                    # port until the source is declared dead
                    self._bulk_addrs.pop(addr, None)
                    raise
        client = self.agent_clients.get_striped(addr, sub)
        if with_crc:
            # Checksum mode trades the zero-copy landing for soundness: a
            # work-steal hedge means a straggler duplicate reply can arrive
            # AFTER another source already landed this chunk — landing
            # unverified bytes in place would overwrite a DONE chunk the
            # ledger will never re-pull (fail on DONE is a no-op).  Fetch
            # to a scratch buffer, verify, THEN copy.
            try:
                res = await client.call(
                    "read_chunk",
                    _timeout=timeout_s,
                    object_id=object_id, offset=off, length=n,
                    with_crc=True)
            except RemoteError as e:
                if isinstance(e.cause, ChunkNotAvailable):
                    raise e.cause from None
                raise
            crc, algo, data = res["crc"], res["algo"], res["data"]
            landed = data.nbytes if isinstance(data, memoryview) \
                else len(data)
            if landed == n:
                got, got_algo = chunk_checksum(data)
                if got_algo == algo and got != crc:
                    raise ChunkCrcError(
                        f"chunk [{off}, {off + n}) from {addr}: checksum "
                        f"mismatch ({got:#x} != {crc:#x})")
                sink[:n] = data
            return landed
        try:
            res = await client.call_into(
                "read_chunk", sink,
                _timeout=timeout_s,
                object_id=object_id, offset=off, length=n)
        except RemoteError as e:
            if isinstance(e.cause, ChunkNotAvailable):
                # typed partial miss: the engine re-stripes the chunk and
                # re-probes this source's advertised ranges
                raise e.cause from None
            raise
        if isinstance(res, memoryview):
            return res.nbytes     # landed in place by the sink receive
        landed = len(res)         # small in-band reply: place it ourselves
        if landed <= n:
            sink[:landed] = res
        return landed

    # ------------------------------------------------------------ OOM defense

    async def _memory_monitor_loop(self):
        """Kill a worker before the kernel OOM-killer takes the whole node.

        Reference: ``src/ray/common/memory_monitor.h:52`` + the raylet's
        worker-killing policies (``worker_killing_policy.h:64`` retriable-
        LIFO, ``worker_killing_policy_group_by_owner.h:85`` group-by-owner,
        selected by config.oom_worker_killing_policy): when node memory
        passes the threshold, kill a leased task-running worker — its task
        retries (bounded by task_oom_retries), and admission backpressure
        (fewer workers) relieves the pressure.  Actors are spared unless
        they are the only candidates (restarting an actor is costlier than
        retrying a task)."""
        cfg = get_config()
        if not cfg.memory_monitor_enabled:
            return
        try:
            import psutil
        except ImportError:
            return
        while not self._shutting_down:
            await asyncio.sleep(cfg.memory_monitor_interval_s)
            try:
                usage = psutil.virtual_memory().percent / 100.0
                if usage < cfg.memory_usage_threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                victim.state = "DRAINING"
                self._oom_kill_count += 1
                try:
                    # This loop runs ON the agent's IO loop: write the
                    # event through our async GCS client (the blocking
                    # events.record() would raise in run_async here).
                    # Keep a strong ref to the task — the loop holds only
                    # weak ones — and record_via swallows KV failures.
                    from ray_tpu_torch.util import events
                    task = asyncio.ensure_future(events.record_via(
                        self.gcs.call, "WARNING", "memory-monitor",
                        f"killed worker {victim.worker_id[:12]}",
                        policy=cfg.oom_worker_killing_policy,
                        usage=f"{usage:.0%}",
                        owner=victim.owner or "",
                        node=self.node_id.hex()[:12]))
                    self._bg_tasks.add(task)
                    task.add_done_callback(self._bg_tasks.discard)
                except Exception:
                    pass  # the kill must proceed even with no live GCS
                cause = (
                    f"worker killed by the memory monitor: node memory "
                    f"{usage:.0%} >= threshold "
                    f"{cfg.memory_usage_threshold:.0%} "
                    f"({cfg.oom_worker_killing_policy} worker killing "
                    f"policy)")
                if victim.is_actor and victim.actor_id:
                    # _kill_worker_proc releases leases but does not tell
                    # the GCS — an unreported actor death would leave the
                    # actor ALIVE forever and hang its callers.  Actors have
                    # no lease return to consume _oom_kills, so thread the
                    # typed cause straight into the death reason instead.
                    try:
                        await self.gcs.call_retry(
                            "report_actor_death", actor_id=victim.actor_id,
                            reason=f"OutOfMemoryError: {cause}")
                    except Exception:
                        pass
                else:
                    self._oom_kills[victim.worker_id] = cause
                    # Bound the dict: an owner that dies before returning
                    # the lease never consumes its entry (insertion order =
                    # kill order, so the evictee is the oldest).
                    while len(self._oom_kills) > 256:
                        self._oom_kills.pop(next(iter(self._oom_kills)))
                await self._kill_worker_proc(victim)
                if victim.owner and not victim.is_actor:
                    # Proactive typed-death delivery: don't rely on the
                    # owner's in-flight RPC seeing EOF — tell the lease
                    # owner directly so it force-fails the connection and
                    # surfaces OutOfMemoryError promptly (the EOF path
                    # remains as backstop).
                    try:
                        await self.worker_clients.get(victim.owner).notify(
                            "worker_killed", worker_id=victim.worker_id,
                            address=victim.address, cause=cause)
                    except Exception:
                        pass
                try:
                    print(f"[memory-monitor] node memory {usage:.0%} >= "
                          f"{cfg.memory_usage_threshold:.0%}: killed worker "
                          f"{victim.worker_id[:12]} "
                          f"({cfg.oom_worker_killing_policy})",
                          flush=True)
                except Exception:
                    pass
            except asyncio.CancelledError:
                raise
            except Exception:
                pass

    def _pick_oom_victim(self):
        # Only REGISTERED leased workers are candidates: a worker that has
        # not called back yet is still booting — its task body is not
        # running, so killing it frees no task memory, and the owner's
        # lease-grant RPC is still parked in _grant_lease's registered.wait
        # (the typed death cause could only reach the owner after the full
        # register timeout, long past any reasonable ray.get deadline).
        leased = [w for w in self.workers.values()
                  if w.state == "LEASED" and w.registered.is_set()]
        tasks = [w for w in leased if not w.is_actor]
        pool = tasks or leased
        if not pool:
            return None
        if get_config().oom_worker_killing_policy == "group_by_owner":
            # Group leased workers by submitting owner; the owner with the
            # LARGEST fan-out loses its newest lease (reference:
            # worker_killing_policy_group_by_owner.h:85).  Singleton groups
            # tie-break to the newest lease overall == retriable-LIFO.
            groups: Dict[str, list] = {}
            for w in pool:
                groups.setdefault(w.owner or w.worker_id, []).append(w)
            grp = max(groups.values(),
                      key=lambda g: (len(g), max(w.leased_at for w in g)))
            return max(grp, key=lambda w: w.leased_at)
        # retriable-LIFO: the newest lease loses the least progress
        return max(pool, key=lambda w: w.leased_at)

    # ---------------------------------------------------------- observability

    async def handle_report_metrics(self, reporter: str, metrics: dict):
        """Workers/drivers push their metric-registry snapshots here
        (reference: stats export to the per-node agent, metric_exporter.h)."""
        if not hasattr(self, "_metrics"):
            self._metrics = {}
        self._metrics[reporter] = metrics
        return True

    async def _start_metrics_endpoint(self):
        """Prometheus text endpoint (reference: metrics_agent.py:375) —
        aiohttp on a random port, advertised via the node's labels."""
        try:
            from aiohttp import web
        except ImportError:
            return

        async def metrics_handler(_request):
            from ray_tpu_torch.util.metrics import (render_prometheus,
                                              snapshot_registry)
            # Refresh the node gauges at scrape time (the telemetry loop
            # keeps them warm between scrapes), then serve the agent's own
            # registry (node gauges, RPC metrics) merged with every
            # worker/driver snapshot pushed via report_metrics.
            self._sample_telemetry()
            per = dict(getattr(self, "_metrics", {}))
            per[f"agent-{self.node_id.hex()[:12]}"] = snapshot_registry()
            return web.Response(text=render_prometheus(per),
                                content_type="text/plain")

        app = web.Application()
        app.router.add_get("/metrics", metrics_handler)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        # bind where the agent's RPC server binds so the dashboard head can
        # scrape remote nodes at their advertised address
        site = web.TCPSite(runner, self.server.host, 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        self._metrics_runner = runner
        self.labels["metrics_port"] = str(port)

    def _sample_telemetry(self):
        """One sample of this node's runtime state into the telemetry
        gauges: shm-pool occupancy (used/free/largest-free, the PR-1
        introspection), outstanding read pins, scheduler queue depth, live
        worker count, and resource capacity.  Called by the periodic
        telemetry loop and again at /metrics scrape time for freshness."""
        g = _telemetry_gauges()
        if g is None:
            return
        tags = {"node": self.node_id.hex()[:12]}
        g["workers"].set(len(self.workers), tags)
        g["workers_leased"].set(
            sum(1 for w in self.workers.values() if w.state == "LEASED"),
            tags)
        g["lease_queue"].set(len(self.lease_queue), tags)
        if object_explain.enabled():
            # every raytpu_object_* / raytpu_mem_* series hangs off the ONE
            # object-plane kill switch (A/B discipline: off means zero
            # series, not zero-valued series)
            st = self.store.stats()
            used = st.get("used", 0)
            cap = st.get("capacity", 0)
            g["store_used"].set(used, tags)
            g["store_capacity"].set(cap, tags)
            g["store_free"].set(max(0, cap - used), tags)
            g["store_largest_free"].set(st.get("largest_free_block", 0),
                                        tags)
            g["store_objects"].set(st.get("num_objects", 0), tags)
            g["store_pinned"].set(st.get("num_pinned", 0), tags)
            g["mem_frag"].set(st.get("frag_fraction", 0.0), tags)
            hist = st.get("free_block_hist") or {}
            g["mem_free_blocks"].set(hist.get("num_free_blocks", 0), tags)
            for tier, bkey, okey in (
                    ("local", "spilled_local_bytes", "num_spilled_local"),
                    ("external", "spilled_external_bytes",
                     "num_spilled_external")):
                ttags = {"node": tags["node"], "tier": tier}
                g["mem_spill_bytes"].set(st.get(bkey, 0), ttags)
                g["mem_spill_objects"].set(st.get(okey, 0), ttags)
            g["mem_leaks"].set(
                len(self._leak_suspects_cheap(
                    get_config().object_pin_leak_ttl_s, time.time())),
                tags)
        g["read_pins"].set(
            sum(count for per in self._read_pins.values()
                for kinds in per.values() for count in kinds.values()),
            tags)
        g["oom_kills"].set(self._oom_kill_count, tags)
        try:
            # session-dir filesystem fullness (statvfs is a syscall, not
            # a walk): logs + local spill land here, so this is the disk
            # that takes the cluster down when it fills
            st = os.statvfs(self.session_dir)
            total = st.f_blocks * st.f_frsize
            free = st.f_bavail * st.f_frsize
            if total > 0:
                g["disk_used_frac"].set(1.0 - free / total, tags)
                g["disk_free"].set(free, tags)
        except (OSError, ValueError):
            pass
        avail = self.available.to_dict()
        for k, total in self.total.to_dict().items():
            rtags = {"node": tags["node"], "resource": k}
            g["resource_available"].set(avail.get(k, 0.0), rtags)
            g["resource_total"].set(total, rtags)

    async def _telemetry_loop(self, period_s: float = 2.0):
        """Periodic node self-measurement (reference: the per-node stats
        reporters feeding metrics_agent.py) — keeps the gauges live even
        when nothing scrapes, so a snapshot pulled through report_metrics
        or a debugger is never minutes stale."""
        while not self._shutting_down:
            try:
                self._sample_telemetry()
            except Exception:
                pass
            await asyncio.sleep(period_s)

    async def _log_monitor_loop(self):
        """Tail worker log files and publish new lines to the GCS pubsub
        topic ``worker_logs`` (reference: _private/log_monitor.py:103 —
        worker stdout/stderr shows up at the driver)."""
        logdir = os.path.join(self.session_dir, "logs")
        offsets: Dict[str, int] = {}
        while not self._shutting_down:
            await asyncio.sleep(0.5)
            try:
                batch = []
                for fn in os.listdir(logdir):
                    if not fn.startswith("worker-"):
                        continue
                    path = os.path.join(logdir, fn)
                    off = offsets.get(fn, 0)
                    size = os.path.getsize(path)
                    if size <= off:
                        continue
                    with open(path, "rb") as f:
                        f.seek(off)
                        data = f.read(min(size - off, 1 << 20))
                    offsets[fn] = off + len(data)
                    lines = data.decode(errors="replace").splitlines()
                    if lines:
                        batch.append({"worker": fn[len("worker-"):-4],
                                      "lines": lines})
                if batch and self.gcs:
                    await self.gcs.call(
                        "publish", topic="worker_logs",
                        payload={"node": self.node_id.hex()[:12],
                                 "batch": batch})
            except asyncio.CancelledError:
                raise
            except Exception:
                pass

    # ----------------------------------------------------------------- misc

    async def handle_ping(self):
        return "pong"

    async def handle_list_logs(self) -> List[dict]:
        """Session log files on this node (reference: dashboard log module's
        per-node listing)."""
        logdir = os.path.join(self.session_dir, "logs")
        out = []
        try:
            for name in sorted(os.listdir(logdir)):
                p = os.path.join(logdir, name)
                if os.path.isfile(p):
                    out.append({"name": name, "size": os.path.getsize(p)})
        except OSError:
            pass
        return out

    async def handle_tail_log(self, name: str, nbytes: int = 65536) -> str:
        """Last `nbytes` of one session log file.  The name is confined to
        the log directory (no path components)."""
        if "/" in name or "\\" in name or name.startswith("."):
            return "(invalid log name)"
        p = os.path.join(self.session_dir, "logs", name)
        try:
            size = os.path.getsize(p)
            with open(p, "rb") as f:
                if size > nbytes:
                    f.seek(size - nbytes)
                return f.read(nbytes).decode("utf-8", "replace")
        except OSError as e:
            return f"(unreadable: {e})"

    async def handle_node_info(self):
        return {"node_id": self.node_id.hex(), "address": self.server.address,
                "total": self.total.to_dict(), "available": self.available.to_dict(),
                "num_workers": len(self.workers),
                "workers": {wid: {"state": w.state, "pid": w.pid,
                                  "actor_id": w.actor_id}
                            for wid, w in self.workers.items()},
                "store": self.store.stats(),
                "oom_kills": self._oom_kill_count,
                "queue_len": len(self.lease_queue),
                "draining": self._draining,
                "backpressure_rejects": dict(self._bp_rejects),
                "loop_busy_fraction": getattr(
                    getattr(self, "_loop_monitor", None),
                    "busy_fraction", None),
                "queued_demands": [r.resources for r in self.lease_queue],
                "cluster_view": {nid: {"available": v.available, "alive": v.alive}
                                 for nid, v in self.cluster_view.items()}}
