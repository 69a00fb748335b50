"""Worker process entrypoint (reference: ``python/ray/_private/workers/default_worker.py``).

Spawned by the node agent with connection info in the environment.  Starts the
CoreWorker RPC server on the IO thread, registers with the agent, then parks the
main thread in the executor loop so user tasks run on the main thread.
"""

from __future__ import annotations

import os
import sys


def main():
    # SIGUSR1 → dump all thread stacks to stderr (lands in the worker log).
    # Debug hook behind `ray stack`-style tooling (reference: py-spy via the
    # dashboard reporter; here faulthandler is dependency-free).
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    gcs_address = os.environ["RAYTPU_GCS_ADDRESS"]
    agent_address = os.environ["RAYTPU_AGENT_ADDRESS"]
    node_id = os.environ["RAYTPU_NODE_ID"]
    worker_id = os.environ["RAYTPU_WORKER_ID"]
    from .common import session_root
    session_dir = os.environ.get("RAYTPU_SESSION_DIR") or session_root()

    from .config import Config, set_config
    cfg_json = os.environ.get("RAYTPU_CONFIG_JSON")
    if cfg_json:
        set_config(Config.from_json(cfg_json))

    from .core_worker import CoreWorker
    from .ids import WorkerID
    from .rpc import run_async

    w = CoreWorker(mode="worker", gcs_address=gcs_address,
                   agent_address=agent_address, node_id=node_id,
                   session_dir=session_dir)
    w.worker_id = WorkerID.from_hex(worker_id)
    w.start()
    # Populate the api-module state so context-dependent utilities (pubsub,
    # util.state, runtime_context helpers) resolve the GCS address inside
    # worker processes too, not just in drivers (reference: workers share the
    # same ``ray._private.worker.global_worker`` context as drivers).
    from . import api
    api._state.worker = w
    api._state.gcs_address = gcs_address
    api._state.session_dir = session_dir
    # retried + token'd: a registration reply lost to a flaky link must
    # not leave the worker unregistered (the agent would reap it) nor
    # register it twice
    res = run_async(w.agent.call_retry("register_worker",
                                       worker_id=worker_id,
                                       address=w.address, pid=os.getpid()))
    if res.get("shutdown"):
        sys.exit(0)

    # Agent watchdog: if our node agent dies (crash, node kill), exit instead
    # of lingering as an orphan (reference: workers die with their raylet).
    import threading
    import time as _time

    def _watchdog():
        misses = 0
        while True:
            _time.sleep(2.0)
            try:
                run_async(w.agent.call("ping", _timeout=3.0), timeout=5)
                misses = 0
            except Exception:
                misses += 1
                if misses >= 3:
                    os._exit(0)

    threading.Thread(target=_watchdog, name="agent-watchdog",
                     daemon=True).start()
    try:
        w.run_executor_loop()
    except KeyboardInterrupt:
        pass
    finally:
        w.shutdown()


if __name__ == "__main__":
    main()
