"""Central config table for the runtime.

Mirrors the *design* of the reference's ``RAY_CONFIG`` macro table
(``src/ray/common/ray_config_def.h:18`` — 204 env-overridable tunables handed to every
process), re-done as a typed Python dataclass whose every field can be overridden with an
``RAYTPU_<NAME>`` environment variable or a ``_system_config`` dict passed to
:func:`ray_tpu_torch.init`.  Worker processes receive the serialized config via their
environment so the whole cluster sees one consistent table.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RAYTPU_"


@dataclasses.dataclass
class Config:
    # -- object store ------------------------------------------------------
    #: Objects <= this many bytes are stored inline in the owner's in-process
    #: memory store and travel inside RPC replies (reference:
    #: ``max_direct_call_object_size``, ray_config_def.h).
    max_direct_call_object_size: int = 100 * 1024
    #: Capacity of the per-node shared-memory store in bytes (0 = 30% of RAM).
    object_store_memory: int = 0
    #: Zero-copy put (reserve-then-write): large puts reserve an arena
    #: range up front from a cheap size estimate and the pickler's
    #: out-of-band buffers land DIRECTLY into the reserved segment
    #: (parallel memoryview gather-write, no intermediate ``bytes``
    #: anywhere) — the ledger's ``put/copies=0`` class.  False restores
    #: the exact prior path (serialize, then one ``write_into`` memcpy):
    #: the ``--ab-zcput`` off arm and the production kill switch.
    zero_copy_put_enabled: bool = True
    #: Gather-write lanes for the zero-copy put landing: buffers >= the
    #: stripe threshold are striped over this many copier threads (numpy
    #: ``copyto`` releases the GIL, so the landing runs at aggregate
    #: memory bandwidth instead of the single-thread memcpy ceiling).
    #: 0 = auto (min(8, cpu count)); 1 = serial landing.
    put_gather_threads: int = 0
    #: BASE chunk size for node-to-node object transfer — the chunk
    #: ledger's bookkeeping/steal/partial-serving unit.  The adaptive
    #: controller claims RUNS of consecutive base chunks (see
    #: ``object_transfer_chunk_max``), so this stays small enough for
    #: fine-grained striping (late-folded relays of a broadcast must
    #: still find claimable chunks) without capping per-request size —
    #: growth recovers large requests on healthy links.
    object_transfer_chunk_bytes: int = 2 * 1024 * 1024
    #: Adaptive per-request ceiling: a source's claim run grows
    #: geometrically under clean completions toward this many bytes and
    #: shrinks on timeout/steal — replacing the fixed chunk size on the
    #: wire.  Growth re-clamps against the receiver's ``largest_free``
    #: arena block so a grown request can never force a spill mid-pull.
    #: <= object_transfer_chunk_bytes disables growth (fixed chunks).
    object_transfer_chunk_max: int = 64 * 1024 * 1024
    #: Parallel sockets per (puller, source) pair: in-flight chunk
    #: requests to one source spread (sticky per chunk) over this many
    #: DEDICATED bulk-channel connections (core/bulk_transfer.py —
    #: threaded blocking sockets, sendall/recv_into straight between shm
    #: and the kernel), so multi-MB replies stream concurrently instead
    #: of serializing head-of-line on one socket and one event loop.
    #: 1 = the historical single shared asyncio connection per peer (the
    #: --ab-zcput off arm).
    transfer_sockets_per_source: int = 4
    #: TOTAL in-flight chunks per object pull, across all sources (the
    #: chunk-ledger stripe's global window).
    object_transfer_parallelism: int = 16
    #: In-flight chunks per SOURCE within one pull (per-source window of
    #: the multi-source stripe).
    object_transfer_per_source_window: int = 4
    #: Per-chunk RPC deadline: a chunk slower than this is failed and
    #: re-striped onto another source (the generic rpc_call_timeout_s is
    #: far too patient for an 8 MB read).
    object_transfer_chunk_timeout_s: float = 30.0
    #: Hedge (work-steal) an in-flight chunk held by another source longer
    #: than this many seconds; 0 = adaptive (2x the median completed-chunk
    #: time, floored at 0.25 s).
    object_transfer_steal_after_s: float = 0.0
    #: Chunk-fetch failures before a source is dropped from the stripe.
    object_transfer_max_source_failures: int = 3
    #: Mid-pull source refresh period: re-poll the owner's location view
    #: and re-probe partial sources' advertised ranges this often.  (The
    #: hot case — a paused relay whose ranges just widened — is probed
    #: event-driven with a 50 ms debounce; this tick only folds in newly
    #: REGISTERED sources, so a broadcast engages relays within its first
    #: chunk-times.)
    object_transfer_source_refresh_s: float = 0.1
    #: Fail a pull that lands NO chunk for this long (all sources dead /
    #: unreachable and the owner offers nothing new).
    object_transfer_stall_timeout_s: float = 60.0
    #: Optional per-chunk checksum on the byte path (native CRC-32C when
    #: the extension builds, zlib.crc32 otherwise): a mismatched chunk is
    #: rejected and re-pulled instead of sealing a corrupt object.
    object_transfer_checksum: bool = False
    #: Partial-object serving: a puller advertises + serves the chunk
    #: ranges it already holds, so an N-node broadcast pipelines through
    #: in-progress pullers instead of waiting for full copies.
    object_transfer_partial_serving: bool = True
    #: Max concurrent inbound object pulls admitted per node.
    object_pull_max_concurrency: int = 8
    #: Use the native C++ shm arena allocator for the store (falls back to
    #: Python file-per-object when g++ is unavailable).
    object_store_use_native_pool: bool = True
    #: Prefault the arena's pages at store startup (MADV_POPULATE_WRITE) so
    #: steady-state puts run at memcpy speed instead of page-fault speed
    #: (plasma pre-touches its dlmalloc arena the same way).
    object_store_prefault: bool = True
    #: Max tasks sent to one leased worker in a single batched push RPC
    #: (reference: ``max_tasks_in_flight_per_worker``).  64 (up from 16):
    #: with per-tick result-push coalescing, bigger batches amortize the
    #: owner-loop per-batch costs without serializing whole-node
    #: parallelism (the pump still splits the queue over expected
    #: capacity) — measured +20% on the 100k-task drain on an 8-worker
    #: box.
    max_tasks_in_flight_per_worker: int = 64
    #: Max actor calls coalesced into one batched submission RPC per handle.
    actor_call_pipeline: int = 32

    # -- submission fast path ---------------------------------------------
    #: Task/actor RETURN values at or under this many bytes travel back
    #: inside the task-reply frame and land directly in the caller's
    #: in-process store — no worker-side ``store_create`` and no
    #: caller-side fetch RPC per result.  0 disables result inlining
    #: entirely (every result goes through the shm store; the perf A/B's
    #: "off" arm).  Streaming-generator yields are NOT governed by this
    #: knob — they keep the plain ``max_direct_call_object_size``
    #: threshold so the yield pipeline is unchanged.
    inline_result_max_bytes: int = 100 * 1024
    #: TaskSpec template cache: the invariant portion of a spec (function
    #: descriptor, options, runtime-env hash) is wire-encoded once per
    #: (function, options) pair and interned by hash on the receiving
    #: worker, so each submission ships only args + ids (core/spec_cache.py).
    spec_cache_enabled: bool = True
    #: Bounded LRU size of the spec template cache, both sender side
    #: (encoded template blobs) and receiver side (interned prototypes).
    spec_cache_max_entries: int = 512
    #: Lease pipelining: when a pool has unmet demand it requests this many
    #: leases BEYOND the current deficit, so the next submission burst finds
    #: a granted worker instead of paying a lease round trip.  0 disables.
    lease_pipeline_window: int = 1
    #: Return a leased worker after it has executed this many tasks even if
    #: more are queued (bounds lease reuse so one pool cannot monopolise a
    #: node's workers; 0 = unlimited reuse).
    lease_reuse_max_tasks: int = 0
    #: Owner-side idle-lease return delay in milliseconds: a leased worker
    #: idle this long with nothing queued is returned to the agent.
    lease_idle_return_ms: float = 2000.0
    #: Max leases requested from one agent in a single batched
    #: ``request_worker_leases`` RPC (same-tick submission bursts coalesce
    #: their lease demand into one control-plane round trip).
    submit_batch_max: int = 16
    # -- scale envelope (million-task submission pipeline) -----------------
    #: Owner-side admission control: max tasks in flight (submitted but not
    #: yet finished/failed) per CoreWorker before ``.remote()`` blocks on
    #: the waitable admission gate.  A driver firing 1M submissions
    #: degrades to smooth pipelining at this window instead of building
    #: 1M specs of owner state and flooding the agents' lease queues.
    #: 0 disables admission control (unbounded in-flight).
    submit_inflight_limit: int = 50_000
    #: Bounded submission flush window in milliseconds: the first
    #: submission of a burst arms the flush; further same-window calls ride
    #: the same flush.  0 flushes on the next loop tick (lowest latency);
    #: >0 trades up to that much latency for bigger push batches.  A buffer
    #: reaching ``submit_flush_max`` flushes immediately regardless.
    submit_flush_window_ms: float = 0.0
    #: Flush the submit buffer immediately once it holds this many entries,
    #: even inside an armed ``submit_flush_window_ms`` window.
    submit_flush_max: int = 512
    #: Master switch for submission batching (the scale-envelope A/B knob):
    #: False degrades to one task per push RPC, one lease per request RPC,
    #: one actor call per batch — the unbatched submission plane.
    submit_batching_enabled: bool = True
    #: Hash-shard count of the GCS hot tables (KV, actor table): rehash
    #: pauses are bounded by the largest shard and maintenance scans can
    #: yield between shards (core/sharded_table.py).
    gcs_table_shards: int = 16
    # -- horizontal control plane (multi-process GCS + submission lanes) ---
    #: Number of GCS shard PROCESSES (core/gcs_shard.py): the hot,
    #: key-partitionable control-plane traffic (KV by namespace, task/
    #: object/sched event fan-in) is served by N subprocesses — each with
    #: its own event loop, RPC server, and snapshot file — fronted by the
    #: router (core/gcs.py), which keeps the globally-ordered concerns
    #: (nodes, jobs, actors, PG 2PC, pubsub).  0 disables (single-process
    #: GCS, exactly the pre-shard behavior).  Changing this count between
    #: incarnations of a persisted GCS is NOT supported: shard snapshot
    #: files restore by shard index (see ARCHITECTURE.md "Horizontal
    #: control plane").
    gcs_shard_processes: int = 0
    #: Parallel client connections to the GCS router/shards per process
    #: (the owner's kv + event-flush traffic fans over these; each extra
    #: connection lives on its own IO-loop lane thread).  1 = the single
    #: shared connection (historical behavior).
    gcs_client_connections: int = 1
    #: IO-loop lanes for the owner's worker/agent connections: addresses
    #: are spread (sticky) over this many loop threads, so the per-frame
    #: pickle/unpickle and socket syscalls of different peers' connections
    #: overlap on separate OS threads instead of serializing on one loop.
    #: Per-lane FIFO ordering is preserved (an address keeps its lane).
    #: 1 = everything on the default loop (historical behavior).
    agent_client_connections: int = 1
    #: Completion batching (the PR-13 drain fast path): workers coalesce
    #: same-tick task results into one ``task_result_batch`` push frame,
    #: and owned-ref batch gets wait on ONE shared future instead of a
    #: per-ref coroutine + Event gather.  The A/B off arm restores the
    #: per-result frame / per-ref wait plane.
    completion_batching_enabled: bool = True
    #: Owner-side serialization thread pool: spec wire-encoding (template
    #: cache + args pickling) for push batches runs on this many pool
    #: threads instead of the RPC loop, overlapping pickle time with the
    #: loop's socket work.  0 encodes inline on the loop (historical).
    owner_serialize_threads: int = 0
    #: Native submission plane (the per-task owner fast path): warm-path
    #: push batches wire-encode into ONE packed binary frame
    #: (spec_cache.pack_specs — C extension when built, byte-identical
    #: pure-Python fallback otherwise), submitted TaskSpecs are slotted
    #: objects recycled through a free-list, and per-ref refcount
    #: mutations take one lock per batch.  False restores the prior
    #: per-spec tuple wire path, ctor-built specs, and per-ref locking
    #: exactly (the ``perf.py --ab-submitplane`` off arm).
    submit_plane_native_enabled: bool = True
    #: Task-event payload sampling: histograms and the submission-plane
    #: counters observe EVERY task; full per-task event trails
    #: (SUBMITTED/RUNNING records) are emitted for 1-in-N tasks.
    #: Terminal events (FINISHED/FAILED) are NEVER sampled away, so the
    #: state rollup still counts every task and ``raytpu explain``
    #: answers for unsampled tasks from their terminal record.
    #: 0 or 1 = full trails for every task (historical behavior).
    task_event_sample_n: int = 0
    #: Capacity of the TaskSpec free-list (submitted specs are recycled
    #: at terminal completion instead of re-allocated per call).
    #: 0 disables recycling.
    spec_freelist_max: int = 4096
    #: Run the EMBEDDED control plane (the GCS server and node agent that
    #: ``init(address=None)`` boots inside the driver process) on their
    #: own IO-loop threads instead of the driver's shared loop — the
    #: single-loop ceiling fix for the one-process head: GCS handlers,
    #: agent lease/store handlers, and the owner submission path stop
    #: contending for one thread.  Off by default (tests may reach into
    #: embedded components assuming loop-0 confinement).
    control_plane_io_lanes: bool = False
    #: Per-topic pubsub log length at the GCS.  Each topic keeps its own
    #: seq-ordered log (polls bisect past their cursor instead of scanning
    #: global traffic); a subscriber lagging more than this many events on
    #: one topic misses the trimmed window, same as the old global ring.
    gcs_pubsub_topic_log_len: int = 4000
    #: Agent-side lease-queue depth bound: a lease request arriving at an
    #: agent whose queue is already this deep is answered with a
    #: ``backpressure`` reply instead of parking — the owner backs off and
    #: re-picks a node, so a 1M-task burst cannot grow an unbounded parked
    #: queue on one agent.  0 disables the bound.
    lease_queue_max_depth: int = 4096
    #: How long an owner waits after a lease ``backpressure`` reply before
    #: re-evaluating its cluster view and retrying.
    lease_backpressure_retry_s: float = 0.2
    #: Spill directory ("" = default under /tmp; "off" disables spilling).
    object_spilling_dir: str = ""
    #: Spill when store utilization exceeds this fraction.
    object_spilling_threshold: float = 0.8
    #: External (fsspec-backed) spill tier base URI — e.g. ``gs://bucket/
    #: prefix`` in production, ``file:///dir`` in tests; "" disables.  When
    #: set, spill-on-evict writes the object once to
    #: ``{uri}/{object_id}.obj`` and registers the URI with the OWNER as a
    #: location that is not a node, so the object survives losing the node
    #: that spilled it and any node's pull path can restore it (the
    #: preemption-survivability tier; reference: ray's
    #: ``object_spilling_config`` smart_open/fsspec spill targets).
    object_spilling_external_uri: str = ""

    # -- scheduling --------------------------------------------------------
    #: Top-k fraction of feasible nodes considered by the hybrid policy
    #: (reference: ``scheduler_top_k_fraction``, hybrid_scheduling_policy.h:51).
    scheduler_top_k_fraction: float = 0.2
    scheduler_top_k_absolute: int = 1
    #: Prefer the local node until its critical-resource utilization passes
    #: this threshold (reference: ``scheduler_spread_threshold``).
    scheduler_spread_threshold: float = 0.5
    #: Lease reuse window: an idle leased worker is returned to the pool after
    #: this many seconds (reference: ``idle_worker_killing_time_threshold_ms``).
    idle_worker_timeout_s: float = 2.0
    #: Escrow grace for distributed refcounting: delay owner-side frees and
    #: borrower-side remove-notes so refs in flight between processes (task
    #: results / actor replies) can be registered by the receiver before the
    #: owner evaluates "no references left".
    ref_escrow_grace_s: float = 10.0
    #: How long an owner honors a producer's escrow hold on a contained ref
    #: before assuming the consumer died (the hold is normally released
    #: explicitly the moment the consumer registers its borrow — this expiry
    #: only bounds the leak window when a consumer crashes mid-handoff).
    escrow_hold_expiry_s: float = 60.0
    #: Max workers a node agent will spawn beyond configured CPU count for
    #: blocked-on-get tasks.
    max_extra_workers: int = 2

    # -- workers -----------------------------------------------------------
    #: Workers pre-started per node at boot (reference: ``prestart_worker_first_driver``).
    prestart_workers: int = 0
    #: Seconds to wait for a worker process to register before declaring it dead.
    worker_register_timeout_s: float = 30.0

    # -- fault tolerance ---------------------------------------------------
    #: Default task max_retries (reference: ``task_retry_delay_ms`` family).
    default_task_max_retries: int = 3
    #: Base delay of the task-retry exponential backoff; retry n sleeps
    #: ~``base * backoff**(n-1)`` capped at ``task_retry_max_delay_s``,
    #: jittered so retry storms under node loss don't synchronize.
    task_retry_delay_s: float = 0.05
    task_retry_max_delay_s: float = 2.0
    task_retry_backoff: float = 2.0
    #: Enable lineage reconstruction of lost objects
    #: (reference: ``lineage_pinning_enabled``, ray_config_def.h:155).
    lineage_reconstruction_enabled: bool = True
    #: Node agent heartbeat period / failure threshold
    #: (reference: GcsHealthCheckManager defaults).
    health_check_period_s: float = 1.0
    health_check_failure_threshold: int = 5
    #: Memory-monitor victim policy: "group_by_owner" kills the newest
    #: worker of the owner with the LARGEST fan-out (reference:
    #: worker_killing_policy_group_by_owner.h:85 — the biggest submitter is
    #: both the likeliest cause and the cheapest to retry); "retriable_lifo"
    #: kills the newest leased task worker regardless of owner.
    oom_worker_killing_policy: str = "group_by_owner"
    #: OOM kills of the SAME task use this separate retry budget (reference:
    #: task_oom_retries) — after this many memory-monitor kills the task
    #: fails with a typed, actionable OutOfMemoryError instead of retrying
    #: forever; -1 = unlimited.
    task_oom_retries: int = 3

    # -- rpc ---------------------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    rpc_call_timeout_s: float = 120.0
    #: Retrying idempotent client (``RpcClient.call_retry``): bounded
    #: attempts with exponential backoff + full jitter under one shared
    #: per-call deadline (reference: retryable gRPC clients).
    rpc_retry_max_attempts: int = 5
    rpc_retry_base_delay_s: float = 0.05
    rpc_retry_max_delay_s: float = 2.0
    #: Server-side idempotency-token dedup window: a retried mutating RPC
    #: carrying the same client-stamped token within this window replays
    #: the recorded reply instead of re-executing the handler.
    rpc_dedup_window_s: float = 600.0
    #: Chaos injection (reference: ray's chaos_network_delay.yaml release
    #: harness).  ``chaos_spec`` is a JSON FaultInjector spec (see
    #: ``core/chaos.py``): per-method/per-link delay, frame drops,
    #: fail-before/after-commit, partitions, and a seeded worker-kill
    #: schedule.  Set RAYTPU_CHAOS_SPEC before booting and every process
    #: inherits it (workers via RAYTPU_CONFIG_JSON); runtime control via
    #: GCS chaos_set/chaos_clear and `raytpu chaos`.
    chaos_spec: str = ""
    #: Legacy single-knob harness: every outbound RPC frame is delayed this
    #: many ms (now a one-rule spec on the same injector); 0 disables.
    chaos_rpc_delay_ms: float = 0.0
    #: Actor __init__ runs arbitrary user code (model loads, XLA compiles —
    #: an LLM replica warms minutes of prefill buckets): the creation call
    #: must not be bounded by the generic RPC timeout, or the agent kills
    #: the worker mid-compile and the GCS retries forever.
    actor_creation_timeout_s: float = 3600.0

    # -- pubsub / syncer ---------------------------------------------------
    #: Resource-view gossip period (reference: RaySyncer, ray_syncer.h:86).
    resource_broadcast_period_s: float = 0.1

    # -- OOM defense -------------------------------------------------------
    #: Kill workers when node memory passes the threshold (reference:
    #: memory_monitor.h:52 + worker_killing_policy.h:64 retriable-LIFO).
    memory_monitor_enabled: bool = True
    memory_monitor_interval_s: float = 1.0
    memory_usage_threshold: float = 0.95

    # -- race / stall detection -------------------------------------------
    #: Opt-in event-loop stall detector (util/loop_monitor.py): a sibling
    #: thread heartbeats each runtime process's IO loop and records a
    #: WARNING event with the blocking stack when an echo is overdue —
    #: the asyncio analogue of the reference's TSAN/sanitizer CI builds
    #: (SURVEY §5.2).
    loop_monitor_enabled: bool = False
    loop_monitor_threshold_s: float = 0.5

    # -- metrics -----------------------------------------------------------
    metrics_export_enabled: bool = True
    #: Serve-plane observability (serve/observability.py): per-request
    #: latency/TTFT/TPOT histograms, queue-depth gauges, batch occupancy,
    #: KV/prefix-cache gauges, request-scoped stage spans, and the rolling
    #: SLO window the controller aggregates.  One kill switch sheds ALL of
    #: it (the serve hot path keeps only a boolean check per request) for
    #: A/B overhead measurement — same discipline as rpc_metrics_enabled.
    serve_metrics_enabled: bool = True
    #: Prefix-cache-aware routing: replica heartbeats carry a bounded
    #: digest of the prefix cache's first-page block hashes; the router
    #: scores its two power-of-two-choices candidates by estimated prefix
    #: overlap x in-flight load.  Off (or on stale/absent digests) the
    #: router falls back to pure p2c — identical to the pre-digest path.
    serve_prefix_routing_enabled: bool = True
    #: Cap on first-page block hashes carried per heartbeat digest.  Keeps
    #: the health-check payload and the router's membership set O(small);
    #: the newest entries win (most recently inserted prefixes).
    serve_prefix_digest_max: int = 32
    #: How strongly a digest hit discounts a candidate's load score:
    #: score = (inflight + 1) * (1 - weight * hit).  0 disables the
    #: discount (pure p2c); 1 makes any hit beat any miss at equal load.
    serve_prefix_routing_weight: float = 0.5
    #: Rolling window over which each replica computes its TTFT
    #: percentiles + queue-depth signal for the controller (the SLO
    #: autoscaler input).  Samples older than this age out.
    serve_slo_window_s: float = 60.0
    #: Train-plane observability (train/observability.py): per-step
    #: wall-clock decomposition (data_wait/host_to_device/step_compute/
    #: checkpoint), first-call compile split out, running MFU + goodput,
    #: device memory gauges, per-step trace spans, and the per-rank
    #: snapshot rollup into train.Result / train.status().  One kill
    #: switch sheds ALL of it (the train loop keeps one boolean check per
    #: phase/report) for A/B overhead measurement — same discipline as
    #: serve_metrics_enabled.
    train_metrics_enabled: bool = True
    #: Cap on per-step trace spans emitted per second per rank (the
    #: task_stage_events_per_s discipline): step/stage HISTOGRAMS observe
    #: every step regardless; only the timeline payload samples beyond
    #: this rate — real accelerator steps run well under it, CPU toy
    #: loops get a sampled timeline.  <= 0 means unlimited.
    train_step_spans_per_s: int = 25
    #: Scheduler/control-plane saturation observability
    #: (core/sched_explain.py): per-event-loop busy-fraction sampling
    #: (``raytpu_loop_busy_fraction{process}``), per-GCS-handler busy
    #: seconds (``raytpu_gcs_handler_seconds{method}``), owner-side
    #: serialization/flush time histograms (``raytpu_sched_owner_*``) and
    #: per-node backpressure-reject counters
    #: (``raytpu_sched_backpressure_total``).  ONE kill switch sheds every
    #: raytpu_sched_*/raytpu_loop_*/raytpu_gcs_* series (hot paths keep a
    #: single boolean check) for A/B overhead measurement — same
    #: discipline as rpc_metrics_enabled.
    sched_metrics_enabled: bool = True
    #: Bounded ring of scheduler decision records kept by the GCS
    #: (candidates/rejection-causes/outcome per pick_node / pack_bundles /
    #: lease-acquisition decision) — the ``raytpu explain`` /
    #: ``state.explain`` backing store.
    sched_decision_ring_len: int = 2048
    #: Decision records older than this age out of the ring (and are
    #: dropped from query replies) — a debug trail, not a history DB.
    sched_decision_max_age_s: float = 600.0
    #: Stamp queued tasks LEASE_QUEUED only after a lease request has been
    #: outstanding this long — a fast grant must not pay a per-task
    #: pending event on the happy path.
    sched_pending_stamp_after_s: float = 0.5
    #: Cap on per-transition pending-reason stamps: when a lease pool's
    #: reason changes, at most this many queued specs get the event (the
    #: decision record carries the full queue count) — a 50k-deep pool
    #: flip must not pin the IO loop stamping every spec.
    sched_explain_stamp_max: int = 1000
    #: Object-plane observability (core/object_explain.py): the per-object
    #: lifecycle flight recorder (CREATED/SEALED/SPILLED/RESTORED/
    #: TRANSFERRED/RE_HOMED/FREED transition events into a bounded GCS
    #: ring), the copy-amplification ledger
    #: (``raytpu_object_bytes_total{path,copies}``), arena fragmentation +
    #: spill-tier gauges (``raytpu_mem_*``), and the per-pull transfer
    #: flight-recorder ring behind ``state.transfers()``.  ONE kill switch
    #: sheds every ``raytpu_object_*``/``raytpu_mem_*`` series AND all
    #: ring writes (hot paths keep a single cached boolean check) for A/B
    #: overhead measurement — same discipline as sched_metrics_enabled.
    object_metrics_enabled: bool = True
    #: Bounded ring of object lifecycle events kept by the GCS (the
    #: ``state.explain_object`` / ``raytpu explain <oid>`` backing store —
    #: the sched_decision ring pattern applied to the data plane).
    object_event_ring_len: int = 4096
    #: Object events older than this age out of the ring (and are dropped
    #: from query replies) — a debug trail, not a history DB.
    object_event_max_age_s: float = 600.0
    #: Bounded per-agent ring of completed-pull ChunkLedger end-states
    #: (per-source bytes/steals/failures/relay fraction) behind
    #: ``state.transfers()`` / ``raytpu transfers``.
    object_transfer_ring_len: int = 256
    #: Ref-debt detector: a read pin held longer than this by a live
    #: consumer is reported as a leak suspect by ``raytpu memory --leaks``
    #: (dead consumers' pins are drained by the liveness sweep already;
    #: this catches the live-but-forgot case).
    object_pin_leak_ttl_s: float = 300.0
    #: Dashboard cluster-metrics history (dashboard/history.py): the head
    #: scrapes every node agent's /metrics on this period into a bounded
    #: ring buffer covering this window, derives counter rates, and serves
    #: GET /api/metrics/history (and the freshest sample on /api/metrics).
    metrics_history_window_s: float = 600.0
    metrics_scrape_period_s: float = 5.0
    #: Per-method RPC client/server latency histograms + byte counters
    #: (core/rpc.py).  Cheap (one histogram observe per call) but the hot
    #: path can shed it entirely for A/B overhead measurement.
    rpc_metrics_enabled: bool = True
    task_events_enabled: bool = True
    #: Per-task lifecycle stage breakdown (queue/dep_fetch/arg_deser/
    #: execute/result_put stamps + STAGES events + the stage histogram).
    #: Rides the task-event stream, so task_events_enabled=False also
    #: disables it; this knob sheds ONLY the breakdown.
    task_stage_breakdown_enabled: bool = True
    #: Cap on per-task STAGES events emitted per second per executor.  The
    #: stage HISTOGRAM observes every task regardless (percentiles stay
    #: exact); only the per-task timeline payload is sampled beyond this
    #: rate, bounding the event-pipeline overhead under small-task floods
    #: (reference: task event buffer sampling).  <= 0 means unlimited.
    task_stage_events_per_s: int = 200
    #: Ring buffer size for task state-transition events
    #: (reference: TaskEventBuffer, task_event_buffer.h).
    task_events_max_buffer: int = 100_000
    #: Health plane (util/health.py): rule-based anomaly detection over
    #: the existing observability surfaces, typed Alerts into a bounded
    #: GCS ring, ``raytpu_health_alerts_total{rule,severity}`` /
    #: ``raytpu_health_active_alerts{rule}``.  ONE kill switch: off means
    #: zero raytpu_health_* series AND no detector CPU (the head scrape
    #: hook and the GCS snapshot hook skip evaluation entirely); the ring
    #: stays queryable and ``raytpu doctor`` still evaluates on demand.
    health_metrics_enabled: bool = True
    #: Bounded ring of alert transition events kept by the GCS (the
    #: sched_decision ring pattern applied to health).
    health_ring_len: int = 512
    #: Alert transitions older than this age out of the ring.
    health_alert_max_age_s: float = 3600.0
    #: Hysteresis: a rule's value must hold at/above raise_at this long
    #: before an alert raises (rules that ARE their own sustain signal —
    #: EVENTS_SHED, NODE_FLAPPING — override to 0).
    health_raise_hold_s: float = 10.0
    #: Hysteresis: an active alert clears only after its value holds
    #: at/below clear_at this long (and the alert is at least this old)
    #: — the min-hold that stops raise/clear flapping.
    health_min_hold_s: float = 30.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))

    @classmethod
    def from_env(cls, overrides: Dict[str, Any] | None = None) -> "Config":
        """Build a config: defaults < env vars < explicit overrides."""
        kwargs: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is not None:
                if f.type in ("int", int):
                    kwargs[f.name] = int(env)
                elif f.type in ("float", float):
                    kwargs[f.name] = float(env)
                elif f.type in ("bool", bool):
                    kwargs[f.name] = env.lower() in ("1", "true", "yes")
                else:
                    kwargs[f.name] = env
        if overrides:
            unknown = set(overrides) - {f.name for f in dataclasses.fields(cls)}
            if unknown:
                raise ValueError(f"Unknown _system_config keys: {sorted(unknown)}")
            kwargs.update(overrides)
        return cls(**kwargs)


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        env = os.environ.get("RAYTPU_CONFIG_JSON")
        _global_config = Config.from_json(env) if env else Config.from_env()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg


def reset_config() -> None:
    """Drop the singleton so the next get_config() re-derives from the
    environment — called by shutdown() so a driver's ``_system_config``
    overrides do not leak into the process's next cluster."""
    global _global_config
    _global_config = None
