"""The port's runtime (``ray_tpu_torch.core``) against the JAX package's.

Every flow of the verify skill runs through both runtimes, one after the
other (``init`` / ``shutdown`` in this file's fixture), and gives the same
result: objects bit for bit (a numpy array over 1 MB, on the shared-memory
path, and a 4 MB CPU bf16 tensor), chained tasks, a raising task's error,
an actor counter, a named actor and ``kill``, a placement group, ``wait``,
a streaming generator.  The accelerator seam differs by name only: the
reference's ``num_tpus`` / ``TPU_VISIBLE_CHIPS`` / ``"TPU"`` are the port's
``num_gpus`` / ``CUDA_VISIBLE_DEVICES`` / ``"GPU"``.  A worker of the port
holds no module of JAX or of the JAX package, and a plain task no torch.
Every runtime file but the seam's is the reference's text with the
package renamed.
"""

import contextlib
import hashlib
import importlib
import os
import re
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import common as ref_common
from ray_tpu_torch import native
from ray_tpu_torch.core import common as port_common
from ray_tpu_torch.util import profiler

#: per runtime: the accelerator keyword, its resource and its ids variable
SEAM = {"ray_tpu": ("num_tpus", "TPU", "TPU_VISIBLE_CHIPS"),
        "ray_tpu_torch": ("num_gpus", "GPU", "CUDA_VISIBLE_DEVICES")}
WAIT_S = 60
#: the reference's fixed session root, which the port does not write
FIXED_ROOT = Path("/tmp/raytpu")


def _digest(a: np.ndarray):
    return (str(a.dtype), a.shape, hashlib.sha256(a.tobytes()).hexdigest())


def flow_worker_modules(pkg):
    """What a plain task's worker has imported, of the roots that matter."""
    @pkg.remote
    def modules():
        import sys
        roots = ("jax", "jaxlib", "ray_tpu", "ray_tpu_torch", "torch")
        return sorted({m.split(".")[0] for m in sys.modules
                       if m.split(".")[0] in roots})

    return pkg.get(modules.remote(), timeout=WAIT_S)


def flow_put_get_numpy(pkg):
    a = np.random.default_rng(0).standard_normal(400_000).astype(np.float32)
    got = pkg.get(pkg.put(a), timeout=WAIT_S)
    return _digest(a), _digest(np.asarray(got))


def flow_put_get_bf16(pkg):
    g = torch.Generator().manual_seed(0)
    t = torch.randn(2 * 1024 * 1024, generator=g).to(torch.bfloat16)
    got = pkg.get(pkg.put(t), timeout=WAIT_S)
    bits = lambda x: _digest(x.view(torch.int16).numpy())  # noqa: E731
    return str(got.dtype), bits(t), bits(got)


def flow_chained(pkg):
    @pkg.remote
    def f(x):
        return x * 2 + 1

    return pkg.get(f.remote(f.remote(3)), timeout=WAIT_S)


def flow_raising_task(pkg):
    @pkg.remote
    def bad(x):
        raise ValueError(f"bad input {x}")

    try:
        pkg.get(bad.remote(7), timeout=WAIT_S)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__, type(e.cause).__name__, str(e.cause)
    return None


def flow_actor_counter(pkg):
    @pkg.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(10)
    return pkg.get([c.incr.remote(), c.incr.remote(5), c.incr.remote()],
                   timeout=WAIT_S)


def flow_named_actor_kill(pkg):
    @pkg.remote
    class Box:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v
            return True

        def read(self):
            return self.v

    b = Box.options(name="box").remote()
    pkg.get(b.set.remote("held"), timeout=WAIT_S)
    value = pkg.get(pkg.get_actor("box").read.remote(), timeout=WAIT_S)
    pkg.kill(b)
    try:
        pkg.get(b.read.remote(), timeout=WAIT_S)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return value, type(e).__name__
    return value, None


def flow_placement_group(pkg):
    strategy = pkg.PlacementGroupSchedulingStrategy
    pg = pkg.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ready = pg.wait(WAIT_S)

    @pkg.remote(num_cpus=1)
    def inside(x):
        return x + 100

    got = pkg.get(inside.options(scheduling_strategy=strategy(
        pg, placement_group_bundle_index=1)).remote(1), timeout=WAIT_S)
    pkg.remove_placement_group(pg)
    return ready, got


def flow_wait(pkg):
    @pkg.remote
    def quick():
        return "quick"

    @pkg.remote
    def slow():
        import time
        time.sleep(2.0)
        return "slow"

    done = quick.remote()
    pkg.get(done, timeout=WAIT_S)
    slows = [slow.remote(), slow.remote()]
    ready, rest = pkg.wait([done] + slows, num_returns=2, timeout=0.5)
    first = (len(ready), len(rest), pkg.get(ready, timeout=WAIT_S))
    ready, rest = pkg.wait(slows, num_returns=2, timeout=WAIT_S)
    return first, (len(ready), len(rest), pkg.get(ready, timeout=WAIT_S))


def flow_streaming_generator(pkg):
    @pkg.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield {"i": i, "sq": i * i}

    stream, out = gen.remote(5), []
    while True:
        try:
            ref = stream.next(timeout=WAIT_S)
        except StopIteration:
            return out
        out.append(pkg.get(ref, timeout=WAIT_S))


def flow_accelerator_resources(pkg):
    """The node's accelerator count from ``init``, a task asking one, and
    one asking more than the node has (it stays pending)."""
    kw, resource, _ = SEAM[pkg.__name__]

    @pkg.remote
    def one():
        return "scheduled"

    total = pkg.cluster_resources().get(resource)
    ran = pkg.get(one.options(**{kw: 1}).remote(), timeout=WAIT_S)
    big = one.options(**{kw: 3}).remote()
    ready, _ = pkg.wait([big], num_returns=1, timeout=1.0)
    pkg.cancel(big)
    return total, ran, len(ready)


def flow_accelerator_ids(pkg):
    """``get_gpu_ids`` inside a task: the ids of the worker's visible
    devices variable (set through ``worker_env``)."""
    kw, _, _ = SEAM[pkg.__name__]

    @pkg.remote
    def ids():
        return pkg.get_gpu_ids()

    return pkg.get(ids.options(**{kw: 1}).remote(), timeout=WAIT_S)


FLOWS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("flow_")}
COMPARED = [f for f in FLOWS if f != "worker_modules"]


def _fixed_root_entries():
    """This process's entries in the reference's fixed session root."""
    if not FIXED_ROOT.is_dir():
        return set()
    return {p.name for p in FIXED_ROOT.iterdir()
            if p.name.endswith(f"-{os.getpid()}")}


@contextlib.contextmanager
def _own_tmpdir(path):
    """``TMPDIR`` set to ``path`` for this process and its children."""
    old_env, old_cached = os.environ.get("TMPDIR"), tempfile.tempdir
    os.environ["TMPDIR"], tempfile.tempdir = str(path), None
    try:
        yield
    finally:
        tempfile.tempdir = old_cached
        if old_env is None:
            os.environ.pop("TMPDIR")
        else:
            os.environ["TMPDIR"] = old_env


def _run_flows(name, tmpdir):
    """Every flow through one runtime under a ``TMPDIR`` of its own: the
    flows' {flow: (status, value, seconds)}, the session directory, and
    what the run added to the fixed session root."""
    pkg = importlib.import_module(name)
    kw, _, ids_env = SEAM[name]
    before = _fixed_root_entries()
    with _own_tmpdir(tmpdir):
        info = pkg.init(num_cpus=4, **{kw: 2}, worker_env={ids_env: "0,1"})
        try:
            out = {}
            for flow, fn in FLOWS.items():
                t0 = time.monotonic()
                try:
                    out[flow] = ("ok", fn(pkg))
                except Exception as e:  # noqa: BLE001 - recorded, asserted
                    out[flow] = ("raised", f"{type(e).__name__}: {e}")
                out[flow] += (time.monotonic() - t0,)
        finally:
            pkg.shutdown()
    return out, info["session_dir"], _fixed_root_entries() - before


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each runtime in turn: {package: (flows, session_dir, fixed-root
    entries, its TMPDIR)}."""
    out = {}
    for name in SEAM:
        tmpdir = tmp_path_factory.mktemp(f"{name}_tmp")
        out[name] = _run_flows(name, tmpdir) + (tmpdir,)
    return out


@pytest.fixture(scope="module")
def results(runs):
    """Every flow through each runtime: {package: {flow: (status, value,
    seconds)}}."""
    return {name: run[0] for name, run in runs.items()}


@pytest.mark.parametrize("flow", COMPARED)
def test_flow_matches_reference(results, flow):
    ref, port = results["ray_tpu"][flow], results["ray_tpu_torch"][flow]
    assert ref[0] == "ok", ref
    assert port[:2] == ref[:2], (port, ref)


def test_flow_values(results):
    """The reference's own results are the right ones, so the comparison
    above holds the port to something."""
    r = {k: v[1] for k, v in results["ray_tpu"].items()}
    a, b = r["put_get_numpy"]
    assert a == b and a[1] == (400_000,)
    dtype, want, got = r["put_get_bf16"]
    assert dtype == "torch.bfloat16" and want == got
    assert r["chained"] == 15
    assert r["raising_task"] == ("TaskError", "ValueError", "bad input 7")
    assert r["actor_counter"] == [11, 16, 17]
    assert r["named_actor_kill"] == ("held", "ActorDiedError")
    assert r["placement_group"] == (True, 101)
    assert r["wait"] == ((1, 2, ["quick"]), (2, 0, ["slow", "slow"]))
    assert r["streaming_generator"] == [{"i": i, "sq": i * i}
                                        for i in range(5)]
    assert r["accelerator_resources"] == (2.0, "scheduled", 0)
    assert r["accelerator_ids"] == ["0", "1"]


def test_port_worker_holds_no_jax_and_no_torch(results):
    status, mods, _ = results["ray_tpu_torch"]["worker_modules"]
    assert status == "ok", mods
    assert mods == ["ray_tpu_torch"], mods


def test_reference_worker_holds_no_port(results):
    status, mods, _ = results["ray_tpu"]["worker_modules"]
    assert status == "ok", mods
    assert "ray_tpu_torch" not in mods and "torch" not in mods, mods


def test_port_session_lives_under_tmpdir(runs):
    """The port's session directory is under ``TMPDIR`` and its run adds
    nothing to the fixed root, which the reference's run writes (so the
    check can see a writer there)."""
    _, session_dir, fixed, tmpdir = runs["ray_tpu_torch"]
    assert Path(session_dir).parent == tmpdir / "raytpu"
    assert (Path(session_dir) / "logs").is_dir()
    assert not fixed, fixed
    assert Path(runs["ray_tpu"][1]).parent == FIXED_ROOT
    assert runs["ray_tpu"][2], "the reference's run wrote no session"


def test_session_root_follows_tmpdir(tmp_path):
    """Sessions, profiles and the head's address file follow ``TMPDIR``."""
    from ray_tpu_torch.core import head_main
    with _own_tmpdir(tmp_path):
        assert port_common.session_root() == str(tmp_path / "raytpu")
        assert head_main.address_file() == str(tmp_path / "raytpu"
                                               / "head.json")


def test_native_libraries_build_outside_the_source(results):
    """The runtime ran on the native store: its library is in the
    git-ignored build directory, none beside the sources."""
    src = Path(native.__file__).parent
    assert Path(native._BUILD_DIR).parent.name == "_build"
    assert (Path(native._BUILD_DIR) / "libshmpool.so").exists()
    assert not list(src.glob("*.so"))


@pytest.mark.parametrize("visible, count", [("0,1", 2), ("3", 1), ("", 0),
                                            (" 0 , 2 ,", 2)])
def test_detect_node_resources_honours_visible_devices(monkeypatch, visible,
                                                        count):
    """``CUDA_VISIBLE_DEVICES`` gives the port's GPU count as
    ``TPU_VISIBLE_CHIPS`` gives the reference's TPU count; no key at 0."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", visible)
    monkeypatch.setattr(port_common, "_nvml_gpu_count", lambda: 0)
    port = port_common.detect_node_resources(num_cpus=2)
    ref = ref_common.detect_node_resources(num_cpus=2)
    assert port.get("GPU", 0) == ref.get("TPU", 0) == count
    assert "TPU" not in port and "GPU" not in ref
    if count == 0:
        assert "GPU" not in port


class _FakeNvml:
    """NVML's three calls, answering ``count`` cards (``init_rc`` from
    ``nvmlInit_v2``)."""

    def __init__(self, count, init_rc=0):
        self.count, self.init_rc, self.shut = count, init_rc, 0

    def nvmlInit_v2(self):
        return self.init_rc

    def nvmlDeviceGetCount_v2(self, ref):
        ref._obj.value = self.count
        return 0

    def nvmlShutdown(self):
        self.shut += 1
        return 0


def _no_library(name):
    raise OSError(f"{name}: cannot open shared object file")


@pytest.mark.parametrize("count", [1, 2])
def test_detect_node_resources_counts_device_nodes(monkeypatch, count):
    """Without ``CUDA_VISIBLE_DEVICES``: the cards NVML reports, not the
    ``/dev/nvidia<N>`` nodes (a one-card container has listed two);
    none where NVML is missing or does not initialise."""
    nvml = _FakeNvml(count)
    assert port_common._nvml_gpu_count(lambda name: nvml) == count
    assert nvml.shut == 1
    assert port_common._nvml_gpu_count(_no_library) == 0
    assert port_common._nvml_gpu_count(lambda name: _FakeNvml(2, 9)) == 0
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(port_common, "_nvml_gpu_count", lambda: count)
    assert port_common.detect_node_resources(num_cpus=1)["GPU"] == count
    assert port_common.detect_node_resources(num_cpus=1, num_gpus=0).get(
        "GPU") is None


def test_accelerator_ids_outside_a_runtime(monkeypatch):
    """``get_accelerator_ids`` reads the process's visible devices."""
    from ray_tpu_torch.core.runtime_context import RuntimeContext
    ctx = RuntimeContext.__new__(RuntimeContext)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 5")
    assert ctx.get_accelerator_ids() == {"GPU": ["2", "5"]}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert ctx.get_accelerator_ids() == {"GPU": []}
    assert not hasattr(ray_tpu_torch, "get_tpu_ids")
    assert hasattr(ray_tpu, "get_tpu_ids")


def test_profiler_samples_stacks_without_cuda(tmp_path):
    """No CUDA context here: the on-demand capture samples stacks and
    never initialises CUDA itself."""
    path, mode = profiler.capture(0.05, str(tmp_path))
    assert mode == "stacks" and Path(path).exists()
    assert not torch.cuda.is_initialized()


ROOT = Path(__file__).resolve().parent.parent
RUNTIME_DIRS = ("core", "native", "util", "dag", "experimental", "train",
                "data")
#: the files where the port's runtime differs from the renamed copy: the
#: GPU seam, the profiler on torch, the build directory, the session
#: root under ``TMPDIR``, ``darray`` on torch; ``util/collective.py`` and
#: ``experimental/darray.py``, whose seams their own copy guards hold as
#: text (``tests/test_torch_collective.py``, ``test_torch_darray.py``);
#: the train library on
#: ``torch.distributed`` and the GPU (``use_gpu``, ``TorchTrainer``, the
#: mesh over the worker's cards, the card's peak and memory), and no
#: ``iter_jax_batches``
SEAM_FILES = {
    "core/__init__.py", "core/actor.py", "core/api.py", "core/cluster.py",
    "core/common.py", "core/core_worker.py", "core/head_main.py",
    "core/node_agent.py", "core/node_main.py", "core/remote_function.py",
    "core/worker_main.py",
    "core/runtime_context.py", "native/__init__.py", "util/profiler.py",
    "util/usage_stats.py", "experimental/__init__.py",
    "util/collective.py", "experimental/darray.py",
    "train/config.py", "train/context.py", "train/observability.py",
    "train/worker_group.py", "train/backend.py", "train/trainer.py",
    "train/__init__.py", "data/dataset.py", "data/iterator.py"}
#: the port's files with no counterpart of the same name: the checkpoint
#: IO, ``jax_utils.py`` in the JAX package
PORT_ONLY_FILES = {"train/torch_utils.py"}
RUNTIME_FILES = sorted(
    str(f.relative_to(ROOT / "ray_tpu_torch"))
    for d in RUNTIME_DIRS for f in (ROOT / "ray_tpu_torch" / d).iterdir()
    if f.suffix in (".py", ".cpp")
    and str(f.relative_to(ROOT / "ray_tpu_torch")) not in PORT_ONLY_FILES)


def _renamed_reference(rel):
    text = (ROOT / "ray_tpu" / rel).read_text()
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


@pytest.mark.parametrize("rel", RUNTIME_FILES)
def test_runtime_file_is_the_renamed_reference(rel):
    """Outside the seam, a runtime file is the JAX package's with
    ``ray_tpu`` renamed: a fix or a drift shows here."""
    got = (ROOT / "ray_tpu_torch" / rel).read_text()
    if rel in SEAM_FILES:
        assert got != _renamed_reference(rel)
    else:
        assert got == _renamed_reference(rel)


def test_runtime_has_the_reference_core():
    """Every module of ``ray_tpu/core``, ``train`` and ``data`` and
    ``ray_tpu/native``'s sources have their counterpart (``train`` keeps
    ``torch_utils.py`` in place of ``jax_utils.py``)."""
    renamed = {"jax_utils.py": "torch_utils.py"}
    for d, pattern in (("core", "*.py"), ("native", "*.cpp"),
                       ("train", "*.py"), ("data", "*.py")):
        want = {renamed.get(f.name, f.name)
                for f in (ROOT / "ray_tpu" / d).glob(pattern)}
        got = {f.name for f in (ROOT / "ray_tpu_torch" / d).glob(pattern)}
        assert want == got, want ^ got
