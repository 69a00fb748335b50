"""Public API: init/shutdown/remote/get/put/wait/kill — reference:
``python/ray/_private/worker.py`` (``ray.init`` :1127, ``get`` :2451, ``put`` :2580,
``wait`` :2643).

``init()`` with no address boots an in-process head node: the GCS-equivalent control
plane and the node agent run on the background IO loop of the driver process (the
reference runs them as separate processes started by ``_private/node.py:1395``; here the
head is embedded, and extra nodes — or a standalone head via ``ray_tpu_torch.core.cluster`` —
are separate processes).  Worker processes are always real subprocesses.
"""

from __future__ import annotations

import asyncio
import atexit
import inspect
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from .actor import (ActorClass, ActorHandle, exit_actor,  # noqa: F401
                    get_actor)
from .common import GetTimeoutError, TaskError, session_root  # noqa: F401
from .config import Config, get_config, set_config
from .core_worker import CoreWorker, global_worker, global_worker_or_none
from .gcs import GcsServer
from .ids import JobID
from .node_agent import NodeAgent
from .object_ref import ObjectRef
from .remote_function import RemoteFunction
from .rpc import run_async


class _GlobalState:
    def __init__(self):
        self.gcs_server: Optional[GcsServer] = None
        self.node_agent: Optional[NodeAgent] = None
        self.worker: Optional[CoreWorker] = None
        self.gcs_address: Optional[str] = None
        self.session_dir: Optional[str] = None
        # IO-loop lanes the embedded control plane runs on (config
        # control_plane_io_lanes; 0 = the shared default loop)
        self.gcs_lane = 0
        self.agent_lane = 0


_state = _GlobalState()


def is_initialized() -> bool:
    return global_worker_or_none() is not None


def init(address: Optional[str] = None,
         *,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         labels: Optional[Dict[str, str]] = None,
         object_store_memory: int = 0,
         namespace: Optional[str] = None,
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         runtime_env: Optional[Dict[str, Any]] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         worker_env: Optional[Dict[str, str]] = None) -> dict:
    """Start (or connect to) a cluster and attach this process as the driver.

    ``address``: None/"local" boots an in-process GCS + node agent;
    "auto" reads ``RAYTPU_GCS_ADDRESS``; "host:port" joins a running
    cluster directly.  There is deliberately no separate ``ray://`` client
    proxy (reference: ``python/ray/util/client``): that proxy exists because
    the reference's driver embeds a heavyweight C++ CoreWorker that can't
    run outside the cluster, whereas this driver is an ordinary RPC peer —
    a remote process passes the GCS address and IS a fully-featured driver
    (``raytpu submit`` covers the fire-and-forget case).
    """
    if is_initialized():
        if ignore_reinit_error:
            return {"address": _state.gcs_address}
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to ignore)")
    if runtime_env:
        # validate BEFORE booting anything: raising after processes start
        # would leave a half-initialized session with no atexit cleanup
        from . import runtime_env as renv
        renv.validate(runtime_env)
    if _system_config:
        set_config(Config.from_env(_system_config))
    # session boundary: the fault injector re-derives from the (possibly
    # just-overridden) config/env instead of keeping a stale cached one
    from .chaos import reset as _reset_chaos
    _reset_chaos()
    session_dir = os.path.join(
        session_root(), f"session-{int(time.time() * 1000)}-{os.getpid()}")
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
    _state.session_dir = session_dir

    # With control_plane_io_lanes the embedded GCS and agent each get
    # their OWN IO-loop thread: GCS handlers, agent lease/store handlers,
    # and the owner submission path stop contending for one loop (the
    # single-process head's structural ceiling — ROADMAP item 5).
    use_lanes = get_config().control_plane_io_lanes
    _state.gcs_lane = "cp-gcs" if use_lanes else 0
    _state.agent_lane = "cp-agent" if use_lanes else 0
    if address in (None, "local"):
        gcs = GcsServer(session_dir=session_dir)
        run_async(gcs.start(), lane=_state.gcs_lane)
        _state.gcs_server = gcs
        gcs_address = gcs.address
    else:
        gcs_address = os.environ.get("RAYTPU_GCS_ADDRESS", "") if address == "auto" \
            else address
        if not gcs_address:
            raise ValueError("address='auto' but RAYTPU_GCS_ADDRESS is not set")
    _state.gcs_address = gcs_address
    os.environ["RAYTPU_GCS_ADDRESS"] = gcs_address

    # Head-resident node agent (every driver process gets a local node unless it
    # explicitly connects to an existing cluster with its own nodes).
    agent = None
    if address in (None, "local"):
        agent = NodeAgent(gcs_address, num_cpus=num_cpus, num_gpus=num_gpus,
                          resources=resources, labels=labels,
                          session_dir=session_dir, worker_env=worker_env,
                          object_store_memory=object_store_memory)
        run_async(agent.start(), lane=_state.agent_lane)
        _state.node_agent = agent

    worker = CoreWorker(mode="driver", gcs_address=gcs_address,
                        agent_address=agent.address if agent else _pick_agent(gcs_address),
                        node_id=agent.node_id.hex() if agent else None,
                        session_dir=session_dir)
    worker.start()
    job_hex = run_async(worker.gcs.call_retry(
        "register_job", metadata={"namespace": namespace or "default"}))
    worker.job_id = JobID.from_hex(job_hex)
    _state.worker = worker
    if runtime_env:
        # ship py_modules/working_dir/env_vars to every worker of this job
        # (reference: runtime_env packaging via the GCS)
        from . import runtime_env as renv
        renv.publish(
            lambda *a, **kw: run_async(worker.gcs.call(*a, **kw)),
            worker.job_id.hex(), runtime_env)
    if log_to_driver:
        _start_log_subscriber(worker)
    # Flush library usages buffered before init (reference:
    # put_pre_init_usage_stats) — recording itself never does I/O.
    from ray_tpu_torch.util import usage_stats
    usage_stats.flush()
    atexit.register(shutdown)
    return {"address": gcs_address, "session_dir": session_dir,
            "node_id": worker.node_id}


def _start_log_subscriber(worker):
    """Stream worker stdout/stderr to this driver (reference:
    log_monitor.py:103 + worker.print_logs): a daemon thread long-polls the
    GCS ``worker_logs`` topic and prefixes each line with its origin."""
    import sys
    import threading

    from .rpc import RpcClient

    def loop():
        client = RpcClient(worker.gcs_address)
        cursor = -1  # -1: start from "now" (first poll returns current seq)
        try:
            cursor, _ = run_async(client.call(
                "pubsub_poll", topics=["worker_logs"], cursor=1 << 60,
                timeout=0.01))
        except Exception:
            cursor = 0
        while _state.worker is worker:
            try:
                cursor, events = run_async(
                    client.call("pubsub_poll", topics=["worker_logs"],
                                cursor=cursor, timeout=5.0),
                    timeout=10.0)
            except Exception:
                time.sleep(1.0)
                continue
            for _seq, _topic, payload in events:
                for entry in payload.get("batch", []):
                    tag = f"({payload.get('node', '?')}:" \
                          f"{entry.get('worker', '?')})"
                    for line in entry.get("lines", []):
                        print(f"{tag} {line}", file=sys.stderr)
        try:
            run_async(client.close(), timeout=2)
        except Exception:
            pass

    threading.Thread(target=loop, daemon=True,
                     name="log-subscriber").start()


def _pick_agent(gcs_address: str) -> Optional[str]:
    """When connecting to an existing cluster, attach to the least-loaded node's
    agent for object-store access."""
    from .rpc import RpcClient
    client = RpcClient(gcs_address)
    view = run_async(client.call_retry("get_cluster_view",
                                       _idempotent=False))
    run_async(client.close())
    alive = {k: v for k, v in view.items() if v.get("alive", True)}
    if not alive:
        return None
    nid = sorted(alive)[0]
    return alive[nid]["address"]


def shutdown():
    w = _state.worker
    if w is not None:
        try:
            # Persist the usage rollup next to the session logs while the
            # GCS is still up (reference: UsageStatsToWrite).  Short
            # timeout: this also runs from atexit against possibly-dead
            # clusters.  Forget the flushed state — a later init must
            # re-report even to a cluster reusing this GCS address.
            from ray_tpu_torch.util import usage_stats
            usage_stats.write_report(timeout_s=1.5)
            usage_stats.forget_flushed_state()
        except Exception:
            pass
        try:
            run_async(w.gcs.call("finish_job", job_id=w.job_id.hex()), timeout=2)
        except Exception:
            pass
        w.shutdown()
        _state.worker = None
    if _state.node_agent is not None:
        try:
            run_async(_state.node_agent.stop(), timeout=5,
                      lane=_state.agent_lane)
        except Exception:
            pass
        _state.node_agent = None
        _state.agent_lane = 0
    if _state.gcs_server is not None:
        try:
            run_async(_state.gcs_server.stop(), timeout=5,
                      lane=_state.gcs_lane)
        except Exception:
            pass
        _state.gcs_server = None
        _state.gcs_lane = 0
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass
    from .chaos import reset as reset_chaos
    from .config import reset_config
    reset_config()
    reset_chaos()  # next init re-derives the injector from config/env


# ---------------------------------------------------------------------------
# Core verbs
# ---------------------------------------------------------------------------

def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("ray_tpu_torch.put() does not accept ObjectRefs")
    return global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    if isinstance(refs, (list, tuple)):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(f"ray_tpu_torch.get() takes ObjectRefs, got {type(bad[0])}")
        return global_worker().get(list(refs), timeout=timeout)
    if not isinstance(refs, ObjectRef):
        raise TypeError(f"ray_tpu_torch.get() takes an ObjectRef, got {type(refs)}")
    return global_worker().get(refs, timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait() takes a list of ObjectRefs")
    return global_worker().wait(list(refs), num_returns=num_returns, timeout=timeout)


async def get_async(ref: ObjectRef):
    return await global_worker().get_async(ref)


def as_future(ref: ObjectRef):
    import concurrent.futures
    fut: concurrent.futures.Future = concurrent.futures.Future()

    async def _resolve():
        try:
            fut.set_result(await global_worker().get_async(ref))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    from .rpc import get_loop
    asyncio.run_coroutine_threadsafe(_resolve(), get_loop())
    return fut


def kill(actor: ActorHandle, *, no_restart: bool = True):
    global_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    """Cooperative cancellation: drop the task from lease queues if it has not
    been dispatched yet.  Runs on the IO loop — the lease pools are loop-
    confined state (reference: CancelTask RPC is best-effort there too)."""
    w = global_worker()
    tid = ref.id.task_id()

    async def _cancel():
        for pool in w.lease_pools.values():
            for spec in list(pool.queue):
                if spec.task_id == tid:
                    pool.queue.remove(spec)
                    w.task_manager.fail(
                        tid, asyncio.CancelledError("task cancelled"))
                    return True
        return False

    return run_async(_cancel())


def remote(*args, **options):
    """@remote decorator for functions and classes (reference: ray.remote)."""
    def make(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and not options and (inspect.isclass(args[0])
                                           or callable(args[0])):
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return make


def method(**options):
    """@method decorator for actor methods (num_returns), reference ray.method."""
    def deco(fn):
        fn.__ray_method_options__ = options
        return fn
    return deco


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def nodes() -> List[dict]:
    view = run_async(global_worker().gcs.call("get_cluster_view"))
    return [{"NodeID": nid, "Alive": d["alive"], "Resources": d["total"],
             "Available": d["available"], "Labels": d.get("labels", {}),
             "AgentAddress": d["address"]} for nid, d in view.items()]


def cluster_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if n["Alive"]:
            for k, v in n["Resources"].items():
                out[k] = out.get(k, 0.0) + v
    return out


def available_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if n["Alive"]:
            for k, v in n["Available"].items():
                out[k] = out.get(k, 0.0) + v
    return out


def timeline() -> List[dict]:
    return run_async(global_worker().gcs.call("list_task_events", limit=10000))
