"""The reference's tier-1 DQN learning gate (tests/test_rllib_dqn.py) on
the port, its runner in-process and its update on the CPU.

The gate runs in a fresh interpreter.  Each ``train()`` makes thousands of
small torch calls, and each releases the GIL and waits for it back: a busy
Python thread that an earlier test leaves in the same worker process (one
that hung past its timeout) stretches 30 iterations from 1.5 s to 191 s,
past the suite's per-test limit.  In its own process the gate depends on
nothing an earlier file left behind.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

# one intra-op thread: under the suite's parallel workers torch's threads
# oversubscribe the cores; no tolerance here depends on the thread count
_GATE = r'''
import json

import numpy as np
import torch

torch.set_num_threads(1)
from ray_tpu_torch.rllib.dqn import DQNConfig

algo = (DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                     rollout_steps=400)
        .training(lr=1e-3, batch_size=64, train_iters=16,
                  target_update_tau=0.005, n_step=3,
                  replay=dict(capacity=50_000, learn_starts=1_000))
        .exploring(epsilon_start=1.0, epsilon_end=0.05,
                   epsilon_decay_steps=10_000)
        .debugging(seed=0)
        .build(device="cpu"))
try:
    best = -np.inf
    for i in range(90):
        result = algo.train()
        best = max(best, result["episode_return_mean"])
        if best >= 60.0:
            break
    print(json.dumps({"best": best, "iterations": i + 1,
                      "loss": result["loss"]}))
finally:
    algo.stop()
'''


def test_dqn_learns_cartpole():
    pytest.importorskip("gymnasium")
    res = subprocess.run([sys.executable, "-c", _GATE], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=150)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    # untrained CartPole hovers near ~20 return; learning must clear it
    assert out["best"] >= 60.0, f"DQN failed to learn: {out}"
    assert np.isfinite(out["loss"])
