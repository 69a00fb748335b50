"""The port stands alone: every module of ray_tpu_torch imports with jax and
ray_tpu blocked (the runtime's without starting a thread or a process or
building anything), ``import ray_tpu_torch`` loads no torch, no module (nor
chip_smoke.py or decode_dispatch_ab.py) imports jax or ray_tpu, the entry
points never drop to the CPU on their own, and no CUDA source uses Ampere's
instructions."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ray_tpu_torch"
BLOCKED_ROOTS = {"jax", "jaxlib", "ray_tpu"}

_BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys

class _Blocker:
    # "ray_tpu_torch" starts with "ray_tpu": block the name and its dotted
    # children only, never the bare prefix
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "ray_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Blocker())
import ray_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                               "ray_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "ray_tpu")]
assert not bad, bad
# importing the runtime starts nothing and builds nothing
import multiprocessing, threading
from ray_tpu_torch import native
assert threading.active_count() == 1, threading.enumerate()
assert not multiprocessing.active_children()
assert (native._LIB, native._SP_LIB, native._CRC_LIB) == (None, None, None)
print("imported", " ".join(names), len(names))
'''


def test_every_module_imports_with_jax_and_ray_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # models.{config,convert,decode,paged_decode,remat,sharding,
    # speculative,transformer}, ops.{_build,attention,flash_attention,moe,
    # splash_attention}, parallel.{mesh,quant_collectives,train_step,zero},
    # serve.llm, train.torch_utils, device, the rllib modules and the six
    # subpackages
    assert int(res.stdout.split()[-1]) >= 25 + len(RLLIB_MODULES), res.stdout
    for name in RUNTIME_MODULES + (
                 "ray_tpu_torch.ops.moe", "ray_tpu_torch.parallel.mesh",
                 "ray_tpu_torch.models.sharding",
                 "ray_tpu_torch.train.torch_utils",
                 "ray_tpu_torch.parallel.zero",
                 "ray_tpu_torch.parallel.quant_collectives") + (
                 RLLIB_MODULES + TRAIN_DATA_MODULES):
        assert name in res.stdout.split(), res.stdout


#: the runtime's subpackages and the modules a worker starts from
RUNTIME_MODULES = tuple(f"ray_tpu_torch.{m}" for m in (
    "core", "core.api", "core.worker_main", "core.node_agent", "core.gcs",
    "core.cluster", "core.head_main", "core.node_main", "native", "util",
    "util.metrics", "util.profiler", "util.usage_stats", "dag",
    "experimental", "experimental.internal_kv"))

RLLIB_MODULES = tuple(f"ray_tpu_torch.rllib.{m}" for m in (
    "replay_buffer", "examples_env", "models", "conv", "optim", "learner",
    "env_runner", "ppo", "a2c", "dqn", "rainbow", "sac", "td3", "ddpg",
    "offline", "impala", "multi_agent", "external", "es", "apex"))

#: the train and data libraries, every module
TRAIN_DATA_MODULES = tuple(f"ray_tpu_torch.train.{m}" for m in (
    "backend", "backend_executor", "checkpoint", "config", "context",
    "elastic", "observability", "result", "storage", "trainer",
    "worker_group")) + tuple(f"ray_tpu_torch.data.{m}" for m in (
        "aggregate", "block", "context", "dataset", "datasource", "exchange",
        "executor", "iterator", "logical", "operators", "planner"))

_LIGHT_IMPORT = r'''
import sys
import ray_tpu_torch
ray_tpu_torch.init, ray_tpu_torch.remote, ray_tpu_torch.get_gpu_ids
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("torch", "jax", "jaxlib", "ray_tpu"))
print("heavy", heavy)
'''


def test_package_import_loads_no_torch():
    """``import ray_tpu_torch`` is the runtime's verbs only, as ``import
    ray_tpu`` loads no jax: workers start from it, and a plain task's
    worker never pays for torch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _LIGHT_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["heavy", "[]"], res.stdout


_NO_GYM_IMPORT = r'''
import sys

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "ray_tpu", "gymnasium"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Blocker())
import ray_tpu_torch.rllib as rl
from ray_tpu_torch.rllib import examples_env
assert examples_env.gym is None
# the learners build and step without gymnasium
algo = rl.DQN.learner_only(rl.DQNConfig(), 4, 2, device="cpu")
rl.APEX.learner_only(rl.APEXConfig(), 4, 2, device="cpu")
rl.ES.learner_only(rl.ESConfig(), 4, 2, device="cpu")
import numpy as np
data = rl.TransitionDataset(*(np.zeros((8, 4), np.float32),
                              np.zeros(8, np.int64), np.zeros(8, np.float32),
                              np.zeros((8, 4), np.float32),
                              np.ones(8, np.float32)))
rl.CQL.learner_only(rl.CQLConfig().training(train_batch_size=4,
                                            updates_per_iter=2),
                    4, 2, device="cpu", data=data).train()
# RockPaperScissors needs no gymnasium: multi-agent PPO runs end to end
ma = rl.MultiAgentPPO(lambda: rl.RockPaperScissors(episode_len=4),
                      lambda aid: aid, num_runners=1, rollout_len=8,
                      hidden=(4,), device="cpu")
ma.train()
try:
    rl.DQNRunner("CartPole-v1", algo.model_spec, device="cpu")
except ImportError as e:
    assert "gymnasium" in str(e), e
else:
    raise AssertionError("a runner built without gymnasium")
print("ok", len(rl.__all__))
'''


def test_rllib_imports_without_gymnasium():
    """The card has no gymnasium: ``import ray_tpu_torch.rllib`` and the
    learners work without it; only the runners and drivers import it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_GYM_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[0] == "ok", res.stdout


def _import_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py",
                          ROOT / "decode_dispatch_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_ray_tpu(path):
    bad = sorted(set(_import_roots(path)) & BLOCKED_ROOTS)
    assert not bad, f"{path.name} imports {bad}"


def test_engine_without_device_raises_when_cuda_is_missing(monkeypatch):
    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.serve.llm import LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(tiny())


def test_rllib_entry_points_without_device_raise_when_cuda_is_missing(
        monkeypatch):
    import ray_tpu_torch.rllib as rl
    from ray_tpu_torch.rllib.models import ActorCriticMLP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: rl.LearnerGroup(ActorCriticMLP(4, 2), {}),
               lambda: rl.LearnerGroup(ActorCriticMLP(4, 2), {},
                                       num_learners=2),
               lambda: rl.DQN.learner_only(rl.DQNConfig(), 4, 2),
               lambda: rl.Rainbow.learner_only(rl.RainbowConfig(), 4, 2),
               lambda: rl.SAC.learner_only(rl.SACConfig(), 3, 1),
               lambda: rl.TD3.learner_only(rl.TD3Config(), 3, 1),
               lambda: rl.APEX.learner_only(rl.APEXConfig(), 4, 2),
               lambda: rl.ES.learner_only(rl.ESConfig(), 4, 2),
               lambda: rl.CQL.learner_only(rl.CQLConfig(), 4, 2,
                                           data=object()),
               lambda: rl.MARWIL.learner_only(rl.MARWILConfig(), 4, 2,
                                              data=object()),
               lambda: rl.IMPALAConfig().environment("CartPole-v1").build(),
               lambda: rl.MultiAgentPPO(rl.RockPaperScissors,
                                        lambda aid: aid),
               lambda: rl.PolicyServerInput(ActorCriticMLP(4, 2), {},
                                            port=0),
               lambda: rl.PPOConfig().environment("CartPole-v1").build(),
               lambda: rl.EnvRunner("CartPole-v1",
                                    dict(obs_dim=4, action_dim=2))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_train_entry_points_without_device_raise_when_cuda_is_missing(
        monkeypatch):
    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.parallel import (init_sharded_state, make_eval_step,
                                        make_optimizer, make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = make_optimizer()
    for fn in (lambda: make_train_step(tiny(), None, opt, None),
               lambda: init_sharded_state(tiny(), None, opt),
               lambda: make_eval_step(tiny(), None, None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrapper dispatches on the tensor's device: a CUDA tensor goes to
    the kernel path (which checks its inputs and raises), never to the
    plain version."""
    from ray_tpu_torch.ops import flash_attention as fa

    called = {}

    def fake_cuda(q, k, v, causal):
        called["cuda"] = True
        raise RuntimeError("kernel path")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    class _FakeCuda:
        type = "cuda"

    class _T:
        device = _FakeCuda()

    monkeypatch.setattr(fa, "_flash_fwd_cuda", fake_cuda)
    monkeypatch.setattr(fa, "flash_attention_reference", no_plain)
    with pytest.raises(RuntimeError, match="kernel path"):
        fa._flash_fwd(_T(), None, None)
    assert called == {"cuda": True}


def test_cuda_tensor_never_takes_the_splash_plain_version(monkeypatch):
    """Splash's forward and backward dispatch on the tensor's device too: a
    CUDA tensor reaches B4's launchers, never the plain versions."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as sa

    reached = []

    def launcher(name):
        def fake(*a, **k):
            reached.append(name)
            raise RuntimeError("kernel path")
        return fake

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for a CUDA tensor")

    class _FakeCuda:
        type = "cuda"

    class _T:
        device = _FakeCuda()
        dtype = torch.bfloat16

    monkeypatch.setattr(fa, "_fwd_launch", launcher("fwd"))
    monkeypatch.setattr(fa, "_delta", lambda out, dout: None)
    monkeypatch.setattr(fa, "_kernel_strides", lambda t: t)
    monkeypatch.setattr(sa, "splash_attention_bwd_dq", launcher("dq"))
    monkeypatch.setattr(fa, "flash_attention_reference", no_plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", no_plain)
    with pytest.raises(RuntimeError, match="kernel path"):
        sa._splash_fwd(_T(), None, None, True, 50.0, 512, 512)

    class _G(_T):
        def to(self, dtype):
            return self

    with pytest.raises(RuntimeError, match="kernel path"):
        sa._splash_bwd(_T(), None, None, None, None, _G(), True, 50.0, 512,
                       512)
    assert reached == ["fwd", "dq"]


_ASM = re.compile(r'asm\s+volatile\s*\((.*?)(?:::|\);)', re.S)


@pytest.mark.parametrize("path", sorted((PORT / "csrc").glob("*.cu*")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_kernel_issues_ampere_instructions(path):
    """Every kernel body is on Hopper's instructions: no asm statement in
    the CUDA sources issues mma.sync, ldmatrix or a cp.async that is not
    TMA's bulk copy (comments may still name the designs they replaced)."""
    code = "".join(m.group(1) for m in _ASM.finditer(path.read_text()))
    assert "mma.sync" not in code and "ldmatrix" not in code
    assert not re.search(r"cp\.async(?!\.bulk)", code)
