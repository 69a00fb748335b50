"""Standalone node agent process entrypoint (reference: ``src/ray/raylet/main.cc:119``).

Used by `Cluster.add_node` to run extra "nodes" on one machine, and by `raytpu start`
to join a real multi-host cluster.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gcs-address", required=True)
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

    from .node_agent import NodeAgent
    from .rpc import get_loop, run_async

    agent = NodeAgent(args.gcs_address,
                      num_cpus=args.num_cpus, num_gpus=args.num_gpus,
                      resources=json.loads(args.resources),
                      labels=json.loads(args.labels),
                      session_dir=args.session_dir or None,
                      object_store_memory=args.object_store_memory)
    run_async(agent.start())
    # A preempted standalone node's PROCESS must disappear (the "VM" is
    # gone): exit hard from the drain path, no orderly unwind.
    agent._on_preempt_exit = lambda graceful: os._exit(0)
    # Report our address on stdout so the parent can address this node.
    print(json.dumps({"node_id": agent.node_id.hex(),
                      "address": agent.address}), flush=True)

    stop = False

    def _sig(*_a):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    import time
    while not stop:
        time.sleep(0.2)
    run_async(agent.stop(), timeout=10)


if __name__ == "__main__":
    main()
