"""The port's serve library (``ray_tpu_torch.serve``) against the JAX
package's.

Three kinds of test:

* the copy guard: every file of ``ray_tpu_torch/serve/`` outside
  ``SEAM_FILES`` is the reference's file with ``ray_tpu`` renamed, and the
  port has every file of ``ray_tpu/serve/``;
* ``import ray_tpu_torch.serve`` loads neither torch nor aiohttp nor grpc
  (a replica of a deployment that runs no model pays for none of them),
  and every serve module imports with jax and ray_tpu blocked;
* the reference's control-plane tests (``tests/test_serve.py``,
  ``test_serve_graph.py``, ``test_serve_ingress.py``,
  ``test_serve_deploy.py``), their source with the package renamed, run
  against the port's runtime: function and class deployments,
  reconfigure, batching, streaming, replica death, the rolling update,
  autoscaling, delete, multiplexing, graphs, the HTTP and ASGI ingress and
  the gRPC ingress, each with the reference test's own assertions, on one
  runtime for the file.
"""

import inspect
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "ray_tpu" / "serve", ROOT / "ray_tpu_torch" / "serve"
#: the files where the port's serve library differs from the renamed
#: reference: the engine is the port's own on torch (``llm.py``)
SEAM_FILES = {"llm.py"}
SERVE_FILES = sorted(str(f.relative_to(PORT)) for f in PORT.rglob("*")
                     if f.is_file() and "__pycache__" not in f.parts)


def _renamed(text):
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


@pytest.mark.parametrize("rel", SERVE_FILES)
def test_serve_file_is_the_renamed_reference(rel):
    """Outside the seam, a serve file is the JAX package's with
    ``ray_tpu`` renamed: a fix or a drift shows here."""
    got = (PORT / rel).read_text()
    want = _renamed((REF / rel).read_text())
    if rel in SEAM_FILES:
        assert got != want
    else:
        assert got == want


def test_serve_has_every_reference_file():
    want = {str(f.relative_to(REF)) for f in REF.rglob("*")
            if f.is_file() and "__pycache__" not in f.parts}
    assert want == set(SERVE_FILES), want ^ set(SERVE_FILES)


_LIGHT_SERVE = r'''
import sys

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Blocker())
import ray_tpu_torch.serve as serve
serve.deployment, serve.run, serve.DeploymentHandle, serve.ingress
heavy = sorted({m.split(".")[0] for m in sys.modules} & {
    "torch", "aiohttp", "grpc", "numpy", "jax", "ray_tpu"})
print("heavy", heavy)
import importlib, pkgutil
names = [m.name for m in pkgutil.iter_modules(serve.__path__)]
for n in names:
    importlib.import_module("ray_tpu_torch.serve." + n)
print("imported", " ".join(sorted(names)))
'''


def test_serve_import_loads_no_torch_aiohttp_or_grpc():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _LIGHT_SERVE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "heavy []", res.stdout
    want = sorted(f.stem for f in REF.glob("*.py") if f.stem != "__init__")
    assert lines[1].split()[1:] == want, res.stdout


# ------------------------------------------ the reference's own tests

#: the reference's control-plane test files, run through the port
REFERENCE_FILES = ("test_serve.py", "test_serve_graph.py",
                   "test_serve_ingress.py", "test_serve_deploy.py")
#: the REST deploy goes through the dashboard, which the port does not
#: have (ROADMAP A4)
NOT_PORTED = {"test_serve_deploy.py::test_deploy_config_rest"}
#: fixtures of the reference files that only stand for "a runtime is up"
RUNTIME_FIXTURES = {"serve_clean", "ray_start_regular"}


def _reference_module(name):
    """The reference test file's source with the package renamed, as a
    module of its own (never in ``sys.modules``: what its tests define is
    shipped to the replicas by value)."""
    path = ROOT / "tests" / name
    mod = types.ModuleType(f"ported_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(_renamed(path.read_text()), str(path), "exec"),
         mod.__dict__)
    return mod


REFERENCE = {name: _reference_module(name) for name in REFERENCE_FILES}
CASES = [f"{name}::{attr}" for name, mod in REFERENCE.items()
         for attr, fn in vars(mod).items()
         if attr.startswith("test_") and inspect.isfunction(fn)
         and f"{name}::{attr}" not in NOT_PORTED]


@pytest.fixture(scope="module")
def runtime():
    """One runtime of the port for the file's flows (the reference's
    ``serve_runtime``: 8 CPUs, so autoscaling reaches 3 replicas)."""
    ray_tpu_torch.init(num_cpus=8, object_store_memory=64 << 20)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("case", CASES)
def test_reference_flow_on_the_port(case, runtime, tmp_path):
    name, attr = case.split("::")
    fn = getattr(REFERENCE[name], attr)
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p == "tmp_path":
            kwargs[p] = tmp_path
        elif p in RUNTIME_FIXTURES:
            kwargs[p] = None
        else:
            raise AssertionError(f"{case} asks for fixture {p!r}")
    try:
        fn(**kwargs)
    finally:
        serve.shutdown()


def test_every_reference_flow_is_ported():
    """Every test of the four reference files runs here, save the one
    that needs the dashboard."""
    names = {f"{name}::{attr}" for name, mod in REFERENCE.items()
             for attr in vars(mod) if attr.startswith("test_")}
    assert names - set(CASES) == NOT_PORTED
    assert len(CASES) == 23


_ONE_AFTER_ANOTHER = r'''
import importlib, sys, threading, time
pkg = importlib.import_module(sys.argv[1])
serve = importlib.import_module(sys.argv[1] + ".serve")
pkg.init(num_cpus=2, object_store_memory=64 << 20,
         worker_env={"JAX_PLATFORMS": "cpu"})

@serve.deployment
class Slow:
    async def __call__(self, i):
        import asyncio, time
        arrived = time.time()
        for _ in range(3):
            await asyncio.sleep(0.5)
        yield (arrived, time.time())

h = serve.run(Slow, timeout_s=60)
got = {}

def one(i):
    got[i] = list(h.stream(i, timeout_s=60))[0]

one(-1)                         # the router's table and handle, cached
t0 = time.time()
first = threading.Thread(target=one, args=(0,))
first.start()
time.sleep(0.5)                 # the first stream is under way
one(1)
first.join(timeout=60)
serve.shutdown()
pkg.shutdown()
(a_in, a_end), (b_in, _) = got[0], got[1]
print("first", a_in - t0, a_end - t0)
print("second", b_in - t0)
'''


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_one_process_streams_run_one_after_another(pkg):
    """ROADMAP C12, a property of both runtimes that the port keeps: a
    process sends its calls to one actor a batch at a time, each after the
    previous batch's reply, and a stream's call replies when the stream
    ends; so a second stream from the same process reaches the replica
    only when the first one (1.5 s) has ended, though it was sent 0.5 s
    after it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _ONE_AFTER_ANOTHER, pkg],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=150)
    assert res.returncode == 0, res.stderr
    out = {line.split()[0]: [float(x) for x in line.split()[1:]]
           for line in res.stdout.splitlines()
           if line.startswith(("first", "second"))}
    (a_in, a_end), (b_in,) = out["first"], out["second"]
    assert a_end - a_in >= 1.45, res.stdout
    assert b_in >= a_end - 0.05, res.stdout
