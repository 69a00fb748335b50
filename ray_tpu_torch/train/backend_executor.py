"""Orchestrates a training run over a WorkerGroup.

Reference: ``python/ray/train/_internal/backend_executor.py:46`` (``start``
:105 boots the worker group + backend hooks, ``start_training`` :344 launches
the loop on all workers).  The result-collection protocol: each round, fetch
one result per live worker (barrier), surface rank-0 metrics, register any
checkpoint, release the barrier.  Worker-group death → ``TrainingFailedError``
which the trainer turns into an elastic restart from the latest checkpoint
(FailureConfig, reference ``air/config.py:523``).

Elastic mode (``ScalingConfig.min_workers``) upgrades worker loss from a
restart to an in-place **resize**: between barrier rounds the executor
polls the GCS drain-notice registry (``train/elastic.py``); when a notice
names a node hosting our workers — or capacity for more workers appears
while running below target — it consumes the signal AT the barrier (all
ranks parked in ``report()``, the round's checkpoint registered), tears
the group down, re-forms it at the new world size, re-splits the dataset
shards, and restarts the user loop from the just-registered checkpoint.
The trainer above never sees a failure; the run's goodput accounting
carries across the transition (resize wall-clock counts as
non-productive) and each transition lands in
``raytpu_train_resizes_total{direction}`` + the GCS resize ring.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import ActorDiedError, GetTimeoutError, RayTpuError, TaskError

from .backend import BackendConfig
from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig
from .elastic import ElasticWatcher, ResizeSignal, fit_world_size
from .worker_group import WorkerGroup

logger = logging.getLogger(__name__)

#: PG-ready budget for an elastic re-form — a drain notice is a deadline,
#: so a re-form that can't place in this window falls back to a smaller
#: world size instead of burning the notice waiting
_RESIZE_PG_TIMEOUT_S = 30.0

#: no-notice worker deaths resize at most this many times in a row before
#: escaping to the rigid TrainingFailedError path — a worker that
#: deterministically dies every round (e.g. an OOM that capacity changes
#: can't fix) must eventually count against FailureConfig.max_failures
#: instead of tearing down and re-forming forever
_MAX_CONSEC_FAILURE_RESIZES = 3


class TrainingFailedError(RuntimeError):
    """The worker group failed (actor death / user exception)."""

    def __init__(self, msg: str, cause: Optional[BaseException] = None,
                 worker_rank: Optional[int] = None):
        super().__init__(msg)
        self.cause = cause
        self.worker_rank = worker_rank


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig,
                 run_config: RunConfig,
                 trial_name: str,
                 trial_dir: str,
                 worker_env: Optional[Dict[str, str]] = None,
                 ckpt_manager: Optional[CheckpointManager] = None):
        self.backend_config = backend_config
        self.backend = backend_config.backend_cls(backend_config)
        self.scaling = scaling_config
        self.run_config = run_config
        self.trial_name = trial_name
        self.trial_dir = trial_dir
        self.worker_env = worker_env
        self.worker_group: Optional[WorkerGroup] = None
        # Shared across elastic restarts (the checkpoint index/top-k state
        # must survive worker-group re-creation).
        self.ckpt_manager = ckpt_manager or CheckpointManager(
            run_config.checkpoint_config, trial_dir)
        #: latest per-run observability rollup (train/observability.py),
        #: refreshed every barrier round from the per-rank snapshots that
        #: piggyback on next_result — lands in Result.train_obs and the
        #: live train.status() registry.
        self.train_obs: Optional[Dict[str, Any]] = None
        # ---- elastic state (inert unless ScalingConfig.min_workers) ----
        self._elastic = scaling_config.elastic
        self._current_workers = scaling_config.num_workers
        self._watcher: Optional[ElasticWatcher] = None
        if self._elastic:
            self._watcher = ElasticWatcher(
                target_workers=scaling_config.num_workers,
                min_workers=scaling_config.min_workers,
                bundle=scaling_config._resources_per_worker_not_none,
                trial=trial_name)
        #: completed-resize records, newest last — surfaced on the rollup
        #: (Result.train_obs["resizes"]) and pushed to the GCS ring
        self.resize_records: List[Dict[str, Any]] = []
        # run-level goodput across resizes: each generation's StepTracker
        # restarts its clocks, so the executor owns the run numerator
        # (accumulated productive seconds) and denominator (wall since the
        # FIRST start_training — resize downtime included)
        self._run_t0: Optional[float] = None
        self._productive_acc = 0.0
        self._gen_productive = 0.0
        #: consecutive no-notice failure resizes (reset by any barrier
        #: round that completes) — bounded by _MAX_CONSEC_FAILURE_RESIZES
        self._consec_failure_resizes = 0
        # stashed so a resize can re-launch the loop without the trainer
        self._train_fn: Optional[Callable] = None
        self._train_config: Optional[Dict[str, Any]] = None
        self._datasets: Optional[Dict[str, Any]] = None
        #: live streaming-split coordinator actors (one per dataset per
        #: generation) — killed on resize/shutdown to free their slots
        self._split_coords: List[Any] = []

    def start(self) -> None:
        self._form_group(self._current_workers)

    def _form_group(self, num_workers: int,
                    pg_timeout_s: float = 120.0) -> None:
        # PG bundles from the ScalingConfig: optional trainer bundle first
        # (reserved for driver-side work), then one bundle per worker
        # (reference: backend_executor places the worker group via the
        # ScalingConfig's placement group, trainer_resources in bundle 0).
        from ray_tpu_torch import placement_group
        bundles = self.scaling.as_placement_group_bundles(num_workers)
        pg = placement_group(bundles,
                             strategy=self.scaling.placement_strategy)
        self.worker_group = WorkerGroup(
            num_workers=num_workers,
            resources_per_worker=self.scaling._resources_per_worker_not_none,
            placement_strategy=self.scaling.placement_strategy,
            worker_env=self.worker_env,
            pg=pg, bundle_offset=self.scaling.num_bundle_offset,
            owns_pg=True, pg_timeout_s=pg_timeout_s)
        self._current_workers = num_workers
        self.backend.on_start(self.worker_group)

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       datasets: Optional[Dict[str, Any]] = None,
                       checkpoint: Optional[Checkpoint] = None) -> None:
        self._train_fn = train_fn
        self._train_config = config
        self._datasets = datasets
        if self._run_t0 is None:
            self._run_t0 = time.monotonic()
        self._start_on_group(checkpoint)

    def _start_on_group(self, checkpoint: Optional[Checkpoint]) -> None:
        """Init sessions + launch the user loop on the CURRENT group —
        the shared tail of start_training and every elastic re-form."""
        wg = self.worker_group
        assert wg is not None, "call start() first"
        self.backend.on_training_start(wg)
        n = len(wg)
        # Per-worker dataset shards: streaming_split(n) gives coherent,
        # locality-aware shards (reference data_config.py default).  A
        # re-form re-splits at the NEW world size — this is the shard
        # rebalance: every epoch's samples spread over however many ranks
        # exist when that epoch runs.
        shard_sets: Dict[int, Dict[str, Any]] = {i: {} for i in range(n)}
        for name, ds in (self._datasets or {}).items():
            if hasattr(ds, "streaming_split"):
                iters = ds.streaming_split(n, equal=True)
                # all n iterators share ONE coordinator actor; actor handles
                # are not refcounted, so without explicit cleanup each resize
                # would strand the previous coordinator's CPU slot — enough
                # to starve the re-form on a cluster sized to the job
                if iters and hasattr(iters[0], "_coord"):
                    self._split_coords.append(iters[0]._coord)
                for i in range(n):
                    shard_sets[i][name] = iters[i]
            else:
                for i in range(n):
                    shard_sets[i][name] = ds
        trial_id = uuid.uuid4().hex[:8]
        # The chief span: start_training actor tasks submitted inside it
        # carry its trace context, so every rank's per-step spans chain
        # into ONE chief -> worker-task -> step trace per run.
        from ray_tpu_torch.util import tracing
        with tracing.span("train_chief", trial=self.trial_name,
                          world_size=str(n)):
            refs = []
            for i, w in enumerate(wg.workers):
                refs.append(w.init_session.remote(
                    world_rank=i, world_size=n,
                    local_rank=wg.local_rank_of[i],
                    local_world_size=wg.local_world_size_of[i],
                    node_rank=wg.node_rank_of[i],
                    experiment_name=self.run_config.name or "train",
                    trial_name=self.trial_name, trial_id=trial_id,
                    trial_dir=self.trial_dir,
                    checkpoint_path=checkpoint.path if checkpoint else None,
                    dataset_shards=shard_sets[i],
                    mesh_spec=self.scaling.mesh))
            ray_tpu_torch.get(refs, timeout=60)
            ray_tpu_torch.get([w.start_training.remote(self._train_fn,
                                                 self._train_config)
                         for w in wg.workers], timeout=60)

    def fetch_next(self, timeout: float = 3600.0):
        """One barrier round.  Returns ("report", rank0_metrics, ckpt) or
        ("done", rank0_value)."""
        while True:
            wg = self.worker_group
            refs = [w.next_result.remote(timeout) for w in wg.workers]
            try:
                results = ray_tpu_torch.get(refs, timeout=timeout)
            except (ActorDiedError, GetTimeoutError) as e:
                # no-notice worker loss re-forms ONE SMALLER (the dead
                # worker's slot may be gone with its node; fit_world_size
                # grows the target back if the capacity is actually there)
                # and at most _MAX_CONSEC_FAILURE_RESIZES times in a row —
                # a deterministic per-round death must escape to the rigid
                # path and count against FailureConfig.max_failures
                min_n = self._watcher.min_workers if self._watcher else 1
                if (self._elastic and isinstance(e, ActorDiedError)
                        and self._consec_failure_resizes
                        < _MAX_CONSEC_FAILURE_RESIZES
                        and self._resize(ResizeSignal(
                            direction="down", reason="failure",
                            target_world_size=max(
                                min_n, self._current_workers - 1)))):
                    # the round is lost (replayed from the latest
                    # checkpoint on the new group) but the JOB survives —
                    # go wait on the re-formed group
                    self._consec_failure_resizes += 1
                    continue
                raise TrainingFailedError(f"worker group failed: {e}",
                                          cause=e)
            except TaskError as e:
                raise TrainingFailedError(
                    f"train loop raised: {e}", cause=e)
            except RayTpuError as e:
                # Typed system faults (OutOfMemoryError, WorkerCrashedError, …)
                # become a restartable training failure, not a raw crash.
                raise TrainingFailedError(f"worker group fault: {e}", cause=e)
            # a completed barrier round means the re-formed group is
            # making progress — the failure-resize budget refills
            self._consec_failure_resizes = 0
            self._collect_obs(results)
            kinds = {r[0] for r in results}
            if kinds == {"done"}:
                return ("done", results[0][1])
            if "done" in kinds:
                raise TrainingFailedError(
                    "mismatched session calls: some workers finished while "
                    "others are still reporting (all workers must call "
                    "train.report the same number of times)")
            # register checkpoint (rank0's path). Multi-host sharded writers
            # (jax_utils.save_pytree writes only addressable shards per host) are
            # only correct when every rank reported the same shared-filesystem
            # directory — divergent paths mean non-rank0 shards would be dropped.
            ckpt = None
            reported = {r[2] for r in results if r[2]}
            if len(reported) > 1:
                logger.warning(
                    "workers reported %d different checkpoint paths %s; using "
                    "rank0's. report(checkpoint=...) requires a shared storage "
                    "root across ranks", len(reported), sorted(reported)[:4])
            for r in results:
                if r[2]:
                    ckpt = Checkpoint(r[2])
                    break
            tracked = None
            if ckpt is not None:
                tracked = self.ckpt_manager.register(ckpt, results[0][1])
            # elastic: consume any pending resize signal HERE — every rank
            # is parked in report() and the coordinated checkpoint (this
            # round's, or the latest earlier one) is registered, so the
            # group can be torn down with nothing in flight
            sig = None
            if self._watcher is not None:
                sig = self._watcher.poll(wg.workers_per_node(),
                                         self._current_workers)
            if sig is not None:
                if self._resize(sig):
                    return ("report", results[0][1], tracked)
                # the resize tore the group down and could not re-form
                # (can't place within _RESIZE_PG_TIMEOUT_S, init failed,
                # …) — the old workers are gone, so resuming them would
                # crash with a raw ActorDiedError.  Raise the typed
                # failure instead: the trainer's FailureConfig path
                # restarts from the checkpoint this round registered.
                raise TrainingFailedError(
                    f"elastic re-form failed ({sig.direction}, "
                    f"{sig.reason}); restarting from checkpoint")
            ray_tpu_torch.get([w.resume.remote() for w in wg.workers], timeout=60)
            return ("report", results[0][1], tracked)

    # ------------------------------------------------------------- elastic

    def _resize(self, sig: ResizeSignal) -> bool:
        """Tear down + re-form the worker group at ``sig``'s target size
        and resume from the latest registered checkpoint.  Returns False
        when the resize cannot proceed (the caller falls back to the
        rigid TrainingFailedError path)."""
        if self._train_fn is None:
            return False
        t0 = time.monotonic()
        wg = self.worker_group
        from_n = self._current_workers
        # bank this generation's productive seconds before the trackers die
        self._productive_acc += self._gen_productive
        self._gen_productive = 0.0
        self._obs_by_rank: Dict[int, dict] = {}
        start_rec = {"direction": sig.direction, "reason": sig.reason,
                     "from": from_n, "ts": time.time(),
                     "node_ids": list(sig.node_ids)}
        if self._watcher is not None:
            self._watcher.publish_resize_started(start_rec)
        # 1. quiesce: abort parks -> SessionFinished in every live loop,
        #    then kill the actors and release the PG
        if wg is not None:
            try:
                ray_tpu_torch.get([w.abort.remote() for w in wg.workers],
                            timeout=15)
            except Exception:
                pass  # dead/draining workers can't ack the abort
            try:
                wg.shutdown(kill=True)
            except Exception:
                pass
            self.worker_group = None
        self._kill_split_coords()
        # 2. size the new world against what the cluster can host NOW
        #    (draining + dead nodes excluded; our own just-freed bundles
        #    counted back in on surviving nodes)
        new_n = max(1, sig.target_world_size or from_n)
        if self._watcher is not None:
            try:
                from .elastic import _gcs_call
                view = _gcs_call("get_cluster_view") or {}
                reclaim = {nid: c for nid, c in
                           (wg.workers_per_node() if wg else {}).items()
                           if nid not in sig.node_ids}
                hi = new_n if sig.direction == "down" \
                    else self._watcher.target
                new_n = fit_world_size(
                    view, self._watcher.bundle,
                    lo=self._watcher.min_workers, hi=hi, reclaim=reclaim)
            except Exception:
                pass
        ckpt = self.ckpt_manager.latest
        logger.warning(
            "elastic resize (%s, %s): world %d -> %d, resuming from %s",
            sig.direction, sig.reason, from_n, new_n,
            ckpt.path if ckpt else "scratch")
        # 3. re-form + relaunch; any failure here falls back to the
        #    trainer's restart-from-checkpoint path
        try:
            self._form_group(new_n, pg_timeout_s=_RESIZE_PG_TIMEOUT_S)
            self._start_on_group(ckpt)
        except Exception:
            logger.exception("elastic re-form at world size %d failed",
                             new_n)
            self.shutdown()
            return False
        # 4. account + publish the transition
        from . import observability as train_obs
        rec = dict(start_rec)
        rec.update({"to": new_n, "wall_s": round(time.monotonic() - t0, 3),
                    "trial": self.trial_name,
                    "checkpoint": ckpt.path if ckpt else None})
        self.resize_records.append(rec)
        train_obs.record_resize(sig.direction)
        if self._watcher is not None:
            self._watcher.publish_resize(rec)
        self._publish_rollup()
        return True

    # ------------------------------------------------------------- obs

    def _collect_obs(self, results) -> None:
        """Fold the per-rank observability snapshots riding this round's
        results into the run rollup + the live train.status() registry.
        A rank piggybacks a snapshot only when its tracker recomputed one
        (~2/s, not per step) — None keeps that rank's previous snapshot."""
        if not hasattr(self, "_obs_by_rank"):
            self._obs_by_rank: Dict[int, dict] = {}
        updated = False
        for i, r in enumerate(results):
            if len(r) > 3 and r[3]:
                self._obs_by_rank[i] = r[3]
                updated = True
        if not updated:
            return
        self._publish_rollup()

    def _publish_rollup(self) -> None:
        from . import observability as train_obs
        rollup = train_obs.aggregate(getattr(self, "_obs_by_rank", {}))
        if rollup is None:
            if not self.resize_records:
                return
            rollup = {"ts": time.time(), "n_workers": self._current_workers}
        prod = rollup.get("productive_s")
        if prod is not None:
            self._gen_productive = max(self._gen_productive, prod)
        rollup["world_size"] = self._current_workers
        if self._elastic or self.resize_records:
            rollup["resizes"] = list(self.resize_records)
            if self._run_t0 is not None:
                wall = max(time.monotonic() - self._run_t0, 1e-9)
                rollup["run_goodput"] = min(
                    1.0, (self._productive_acc + self._gen_productive)
                    / wall)
        self.train_obs = rollup
        train_obs.publish_status(self.trial_name, rollup)

    def _kill_split_coords(self) -> None:
        coords, self._split_coords = self._split_coords, []
        for coord in coords:
            try:
                ray_tpu_torch.kill(coord)
            except Exception:
                pass

    def shutdown(self) -> None:
        self._kill_split_coords()
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self.ckpt_manager.latest
