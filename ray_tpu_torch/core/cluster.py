"""Multi-node-cluster-in-one-machine test utility.

Reference: ``python/ray/cluster_utils.py:102`` (``Cluster`` — ``add_node`` spawns a real
raylet+workers per "node", so distributed scheduling/failover is tested without a real
cluster; SURVEY §4 calls this the load-bearing test trick).  Each added node here is a
real agent subprocess with its own worker pool and object store; ``kill_node`` is the
fault-injection hook (reference: ``NodeKillerActor``, ``test_utils.py:1401``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .common import session_root
from .gcs import GcsServer
from .rpc import RpcClient, run_async


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, node_id: str, address: str):
        self.proc = proc
        self.node_id = node_id
        self.address = address

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class Cluster:
    """Boot a GCS + N agent subprocesses on localhost."""

    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self.session_dir = os.path.join(
            session_root(), f"cluster-{int(time.time() * 1000)}-{os.getpid()}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.gcs = GcsServer(session_dir=self.session_dir)
        run_async(self.gcs.start())
        self.nodes: List[ClusterNode] = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        return self.gcs.address

    def add_node(self, num_cpus: float = 2, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: int = 256 * 1024 * 1024) -> ClusterNode:
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node_main",
               "--gcs-address", self.gcs.address,
               "--num-cpus", str(num_cpus),
               "--num-gpus", str(num_gpus),
               "--resources", json.dumps(resources or {}),
               "--labels", json.dumps(labels or {}),
               "--session-dir", self.session_dir,
               "--object-store-memory", str(object_store_memory)]
        logf = open(os.path.join(self.session_dir, "logs",
                                 f"node-{len(self.nodes)}.log"), "ab", buffering=0)
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=logf, env=env)
        line = proc.stdout.readline().decode()
        info = json.loads(line)
        node = ClusterNode(proc, info["node_id"], info["address"])
        self.nodes.append(node)
        return node

    def kill_node(self, node: ClusterNode, sigkill: bool = True):
        """Fault injection: hard-kill an agent (and its workers die with it via
        our subprocess monitoring on agent side being gone — workers become
        orphans and exit when their agent connection drops)."""
        if sigkill:
            node.proc.kill()
        else:
            node.proc.terminate()
        node.proc.wait(timeout=10)

    def wait_for_nodes(self, n: Optional[int] = None, timeout: float = 30.0):
        n = n if n is not None else len(self.nodes)
        client = RpcClient(self.gcs.address)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                view = run_async(client.call("get_cluster_view"))
                if sum(1 for v in view.values() if v["alive"]) >= n:
                    return True
                time.sleep(0.1)
            return False
        finally:
            run_async(client.close())

    def connect_driver(self, **kwargs):
        from . import api
        return api.init(address=self.gcs.address, **kwargs)

    def shutdown(self):
        for node in self.nodes:
            if node.alive:
                node.proc.terminate()
        for node in self.nodes:
            try:
                node.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                node.proc.kill()
        run_async(self.gcs.stop(), timeout=5)
