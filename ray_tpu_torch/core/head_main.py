"""Head-node daemon: GCS server + a local node agent in one process.

Reference: what ``ray start --head`` boots via ``_private/node.py:1395``
(``start_head_processes``) — GCS, raylet, and the address file other
processes discover the cluster through.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time


def address_file() -> str:
    """The head's address file, under the session root (``TMPDIR``)."""
    from .common import session_root
    return os.path.join(session_root(), "head.json")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", type=str, default="{}")
    p.add_argument("--labels", type=str, default="{}")
    p.add_argument("--session-dir", type=str, default="")
    p.add_argument("--object-store-memory", type=int, default=0)
    args = p.parse_args()

    from .config import Config, set_config
    cfg_json = os.environ.get("RAYTPU_CONFIG_JSON")
    if cfg_json:
        set_config(Config.from_json(cfg_json))

    from .common import session_root
    from .gcs import GcsServer
    from .node_agent import NodeAgent
    from .rpc import run_async

    session_dir = args.session_dir or os.path.join(
        session_root(), f"head-{int(time.time() * 1000)}-{os.getpid()}")
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)

    gcs = GcsServer(session_dir=session_dir)
    run_async(gcs.start())
    agent = NodeAgent(gcs.address,
                      num_cpus=args.num_cpus, num_gpus=args.num_gpus,
                      resources=json.loads(args.resources),
                      labels=json.loads(args.labels),
                      session_dir=session_dir,
                      object_store_memory=args.object_store_memory)
    run_async(agent.start())

    addr_file = address_file()
    os.makedirs(os.path.dirname(addr_file), exist_ok=True)
    with open(addr_file, "w") as f:
        json.dump({"gcs_address": gcs.address, "pid": os.getpid(),
                   "session_dir": session_dir,
                   "node_id": agent.node_id.hex()}, f)
    print(json.dumps({"gcs_address": gcs.address,
                      "session_dir": session_dir}), flush=True)

    stop = False

    def _sig(*_a):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    while not stop:
        time.sleep(0.2)
    run_async(agent.stop(), timeout=10)
    try:
        os.unlink(addr_file)
    except OSError:
        pass


if __name__ == "__main__":
    main()
