"""GCS shard process — one horizontal slice of the control plane.

Promotes ``core/sharded_table.py``'s in-process hash-partition lines to
PROCESS boundaries (ROADMAP item 5; the Ray paper's sharded-GCS
scalability claim): each shard is a subprocess with its own event loop,
RPC server, snapshot file, and bounded event rings, serving the hot
key-partitionable traffic —

* **namespaced KV** (function registry, workflow step commits) for the
  namespaces that hash to it (``gcs_router.shard_index``),
* **fan-in rings**: task events, object lifecycle events, scheduler
  decision records appended by the owners/agents whose identity hashes
  to it (reads merge across all shards at the router).

Globally-ordered concerns (node table, jobs, actor registration, PG 2PC,
pubsub seq space) stay on the router (``core/gcs.py``) — see
ARCHITECTURE.md "Horizontal control plane" for the split and why.

Per-shard observability: the shard installs its own loop monitor as
``process="gcs_shard:<i>"`` and attributes handler busy seconds into
``raytpu_gcs_handler_seconds{method,shard="<i>"}``; ``shard_stats``
returns the rollup the router aggregates into ``sched_stats``.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import sched_explain
from .config import get_config
from .rpc import RpcServer
from .sharded_table import SecondaryIndex, ShardedTable


class GcsShardServer:
    """The in-process server object one shard subprocess hosts (tests may
    also run it in-process; nothing here assumes a private process beyond
    the loop monitor's process tag)."""

    def __init__(self, index: int, num_shards: int,
                 host: str = "127.0.0.1", port: int = 0,
                 persistence_path: Optional[str] = None):
        self.index = index
        self.num_shards = num_shards
        self.server = RpcServer(self, host, port)
        cfg = get_config()
        table_shards = max(1, cfg.gcs_table_shards)
        self.kv: ShardedTable = ShardedTable(table_shards)
        self._kv_ns_index = SecondaryIndex()
        self.task_events: deque = deque(maxlen=cfg.task_events_max_buffer)
        self.task_events_dropped = 0
        #: latest submission-plane counter snapshot per owner
        self.submit_plane_counters: Dict[str, dict] = {}
        self.sched_decisions: deque = deque(
            maxlen=max(64, cfg.sched_decision_ring_len))
        self.object_events: deque = deque(
            maxlen=max(64, cfg.object_event_ring_len))
        self.object_events_dropped = 0
        self.persistence_path = persistence_path
        self._handler_busy: Dict[str, float] = {}
        self._handler_calls: Dict[str, int] = {}
        self._hist_keys: Dict[str, tuple] = {}
        self._started_at = time.time()

    # ------------------------------------------------------------------ boot

    async def start(self):
        self._maybe_restore()
        if sched_explain.enabled():
            self.server.busy_cb = self._on_handler_busy
        await self.server.start()
        from ray_tpu_torch.util.loop_monitor import install as _install_loop_mon
        self._loop_monitor = _install_loop_mon(
            asyncio.get_event_loop(), f"gcs_shard:{self.index}")
        return self

    @property
    def address(self) -> str:
        return self.server.address

    async def stop(self):
        if getattr(self, "_loop_monitor", None):
            self._loop_monitor.stop()
        await self.server.stop()

    # ----------------------------------------------------------- persistence

    def _maybe_restore(self):
        p = self.persistence_path
        if p and os.path.exists(p):
            with open(p, "rb") as f:
                snap = pickle.load(f)
            # entry-by-entry like the router: gcs_table_shards may change
            # between incarnations (the PROCESS-shard count may not — the
            # snapshot records it so a mismatch fails loudly instead of
            # silently serving misrouted keys)
            snapped = snap.get("num_shards")
            if snapped is not None and snapped != self.num_shards:
                raise RuntimeError(
                    f"shard snapshot {p} was written for "
                    f"gcs_shard_processes={snapped}, booting with "
                    f"{self.num_shards} — resharding persisted state is "
                    "not supported")
            for k, v in snap.get("kv", {}).items():
                self.kv[k] = v
                self._kv_ns_index.add(k[0], k[1])

    def _persist(self):
        p = self.persistence_path
        if not p:
            return
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"kv": self.kv.to_dict(),
                         "index": self.index,
                         "num_shards": self.num_shards}, f)
        os.replace(tmp, p)

    # ------------------------------------------------------------------- KV
    #
    # Same handler contracts as the router's pre-shard KV (synchronous
    # persistence on mutation: a workflow step's commit must be on disk
    # before its kv_put acks).

    async def handle_kv_put(self, ns: str, key: str, value: bytes,
                            overwrite: bool = True):
        k = (ns, key)
        if not overwrite and k in self.kv:
            return False
        self.kv[k] = value
        self._kv_ns_index.add(ns, key)
        self._persist()
        return True

    async def handle_kv_get(self, ns: str, key: str):
        return self.kv.get((ns, key))

    async def handle_kv_multi_get(self, ns: str, keys: List[str]):
        return {k: self.kv[(ns, k)] for k in keys if (ns, k) in self.kv}

    async def handle_kv_del(self, ns: str, key: str):
        existed = self.kv.pop((ns, key), None) is not None
        if existed:
            self._kv_ns_index.discard(ns, key)
            self._persist()
        return existed

    async def handle_kv_keys(self, ns: str, prefix: str = ""):
        return [k for k in self._kv_ns_index.get(ns) if k.startswith(prefix)]

    async def handle_kv_exists(self, ns: str, key: str):
        return (ns, key) in self.kv

    # ------------------------------------------------------------ event rings
    #
    # Identical write contracts to the router's rings; reads return this
    # shard's slice — the router merges slices for the state API.

    async def handle_add_task_events(self, events: List[dict],
                                     dropped: int = 0,
                                     counters: dict | None = None):
        self.task_events.extend(events)
        if dropped:
            self.task_events_dropped += dropped
        if counters:
            # latest submission-plane snapshot per owner (shard-local;
            # the router merges shard maps into its sched_stats rollup)
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
        return out

    async def handle_find_task_events(self, id: str):
        """Events mentioning one task/actor id (the router's explain
        fan-out primitive)."""
        return [ev for ev in self.task_events
                if ev.get("task_id") == id or ev.get("actor_id") == id]

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
        return out

    def _prune_decisions(self):
        max_age = get_config().sched_decision_max_age_s
        if max_age <= 0:
            return
        cutoff = time.time() - max_age
        d = self.sched_decisions
        while d and d[0].get("ts", 0.0) < cutoff:
            d.popleft()

    async def handle_add_sched_decisions(self, records: List[dict]):
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
            if id is not None and not (
                    rec.get("id") == id
                    or (rec.get("task_ids") and id in rec["task_ids"])):
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    # ---------------------------------------------------------------- stats

    def _on_handler_busy(self, method: str, busy_s: float):
        self._handler_busy[method] = \
            self._handler_busy.get(method, 0.0) + busy_s
        self._handler_calls[method] = self._handler_calls.get(method, 0) + 1
        hist = sched_explain.gcs_handler_hist()
        if hist is not None:
            key = self._hist_keys.get(method)
            if key is None:
                key = self._hist_keys[method] = (
                    ("method", method), ("shard", str(self.index)))
            hist.observe_key(key, busy_s)

    async def handle_shard_stats(self):
        mon = getattr(self, "_loop_monitor", None)
        busy = {m: round(s, 6) for m, s in self._handler_busy.items()}
        return {
            "shard": self.index,
            "handler_busy_s": busy,
            "handler_calls": dict(self._handler_calls),
            "loop_busy_fraction": getattr(mon, "busy_fraction", None),
            "loop_stalls": getattr(mon, "stall_count", None),
            "kv_entries": len(self.kv),
            "task_event_ring_len": len(self.task_events),
            "task_events_dropped": self.task_events_dropped,
            "object_event_ring_len": len(self.object_events),
            "object_events_dropped": self.object_events_dropped,
            "decision_ring_len": len(self.sched_decisions),
            "submit_plane": dict(self.submit_plane_counters),
            "pid": os.getpid(),
        }

    async def handle_ping(self):
        return "pong"


# --------------------------------------------------------------- spawning

def spawn_shard_processes(num: int, persistence_path: Optional[str],
                          session_dir: Optional[str] = None,
                          only_index: Optional[int] = None
                          ) -> List[Tuple[object, str]]:
    """Spawn shard subprocesses; -> [(Popen, address), ...].

    Spawns all ``num`` shard indices, or just ``only_index`` (the
    supervisor's respawn path — the replacement keeps its index, so its
    snapshot file and key ownership are unchanged).  Each shard persists
    to ``{persistence_path}.shard{i}`` (nothing when persistence is off).
    The shards inherit this process's config via RAYTPU_CONFIG_JSON so
    chaos specs / table-shard counts agree."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["RAYTPU_CONFIG_JSON"] = get_config().to_json()
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    indices = range(num) if only_index is None else [only_index]
    for i in indices:
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs_shard",
               "--index", str(i), "--num-shards", str(num)]
        if persistence_path:
            cmd += ["--persist", f"{persistence_path}.shard{i}"]
        stderr = subprocess.DEVNULL
        if session_dir:
            logs = os.path.join(session_dir, "logs")
            os.makedirs(logs, exist_ok=True)
            stderr = open(os.path.join(logs, f"gcs-shard-{i}.log"),
                          "ab", buffering=0)
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=stderr, env=env))
    out = []
    import json as _json
    for i, proc in zip(indices, procs):
        line = proc.stdout.readline().decode()
        if not line.strip():
            # the child died before its handshake (import error, port
            # bind failure): fail LOUDLY with the place to look, and
            # reap everything already spawned instead of leaking it
            for p in procs:
                try:
                    p.kill()
                except Exception:
                    pass
            where = (os.path.join(session_dir, "logs", f"gcs-shard-{i}.log")
                     if session_dir else "(stderr discarded; pass a "
                     "session_dir for shard logs)")
            raise RuntimeError(
                f"GCS shard {i} exited before its handshake "
                f"(rc={proc.poll()}); see {where}")
        info = _json.loads(line)
        out.append((proc, info["address"]))
    return out


def main():
    import argparse
    import json
    import signal

    p = argparse.ArgumentParser()
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--num-shards", type=int, required=True)
    p.add_argument("--persist", type=str, default="")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()

    from .config import Config, set_config
    cfg_json = os.environ.get("RAYTPU_CONFIG_JSON")
    if cfg_json:
        set_config(Config.from_json(cfg_json))
    from .rpc import run_async

    shard = GcsShardServer(args.index, args.num_shards, host=args.host,
                           port=args.port,
                           persistence_path=args.persist or None)
    run_async(shard.start())
    print(json.dumps({"address": shard.address, "index": args.index,
                      "pid": os.getpid()}), flush=True)

    stop = False
    parent = os.getppid()

    def _sig(*_a):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    while not stop:
        time.sleep(0.2)
        # Parent-death watch: a router killed without SIGTERM-ing its
        # fleet (kill -9, OOM) must not leave orphan shards running — a
        # RESTARTED router spawns fresh shards sharing these snapshot
        # paths, and an orphan's late persist could clobber a commit the
        # replacement already acked as durable.
        if os.getppid() != parent:
            break
    run_async(shard.stop(), timeout=5)


if __name__ == "__main__":
    main()
