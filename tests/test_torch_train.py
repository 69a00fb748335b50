"""The port's train library (``ray_tpu_torch.train``) against the JAX
package's.

Each protocol test of ``tests/test_train.py`` (reports, the checkpoint
round trip and resume, failure recovery, exhausted retries, dataset-shard
ingest, top-k retention, a ``file://`` storage URI) runs through both
packages' ``DataParallelTrainer``, one runtime per package (this file's
fixture), and must give the same results.  Then the port's own trainer,
``TorchTrainer``: two ranks all-reduce over gloo; one rank trains JAX's
``tiny`` config on the CPU from JAX's init state, fed by a
``ray_tpu_torch.data`` dataset, and its losses are JAX's ``make_train_step``
losses within 1e-4 (f32 sums in another order, as
``tests/test_torch_train_step.py``); and ``use_gpu=True`` without a card
raises.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import config as jcfg
from ray_tpu.parallel import MeshSpec
from ray_tpu.parallel import train_step as jts
from ray_tpu.utils.testing import CPU_WORKER_ENV

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: each runtime's shared-memory arena: this file moves a few kB
STORE_BYTES = 64 << 20
LOSS_ATOL = 1e-4


@pytest.fixture(scope="module", params=PACKAGES)
def pkg(request):
    """One runtime per package for the file's protocol tests (pytest runs
    every test of one parameter before the next)."""
    mod = importlib.import_module(request.param)
    if request.param == "ray_tpu":
        mod.init(num_cpus=4, object_store_memory=STORE_BYTES,
                 worker_env=dict(CPU_WORKER_ENV))
    else:
        # a declared card on this CPU box: use_gpu=True is placed, and the
        # process group's setup must then fail, not fall back
        mod.init(num_cpus=4, num_gpus=1, object_store_memory=STORE_BYTES)
    yield mod
    mod.shutdown()


def _train(pkg):
    return importlib.import_module(pkg.__name__ + ".train")


def _write_step(step):
    import json
    import tempfile
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "s.json"), "w") as f:
        json.dump({"step": step}, f)
    return d


def _read_step(ckpt):
    import json
    with open(os.path.join(ckpt.path, "s.json")) as f:
        return json.load(f)["step"]


def loop_reports(config):
    train = importlib.import_module(config["pkg"] + ".train")
    ctx = train.get_context()
    for step in range(3):
        train.report({"step": step, "rank": ctx.get_world_rank(),
                      "world_size": ctx.get_world_size()})


def loop_checkpoints(config):
    train = importlib.import_module(config["pkg"] + ".train")
    ckpt = train.get_checkpoint()
    start = _read_step(ckpt) + 1 if ckpt else 0
    for step in range(start, 2):
        train.report({"step": step},
                     checkpoint=train.Checkpoint(_write_step(step)))


def loop_crashes_once(config):
    train = importlib.import_module(config["pkg"] + ".train")
    ckpt = train.get_checkpoint()
    start = _read_step(ckpt) + 1 if ckpt else 0
    for step in range(start, 4):
        if step == 2 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("injected failure at step 2")
        train.report({"step": step},
                     checkpoint=train.Checkpoint(_write_step(step)))


def loop_always_fails(config):
    raise ValueError("always fails")


def loop_ingest(config):
    train = importlib.import_module(config["pkg"] + ".train")
    shard = train.get_dataset_shard("train")
    rows = sum(len(b["id"]) for b in
               shard.iter_batches(batch_size=8, batch_format="numpy"))
    train.report({"rows": rows})


def loop_uri(config):
    import tempfile
    train = importlib.import_module(config["pkg"] + ".train")
    ckpt = train.get_checkpoint()
    start = 0
    if ckpt:
        with ckpt.as_directory() as d:
            start = int(open(os.path.join(d, "it.txt")).read()) + 1
    for i in range(start, 3):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "it.txt"), "w") as f:
            f.write(str(i))
        train.report({"iter": i}, checkpoint=train.Checkpoint(d))


def _fit(pkg, loop, path, name, workers=1, **kw):
    train = _train(pkg)
    run_kw = {k: kw.pop(k) for k in ("failure_config", "checkpoint_config")
              if k in kw}
    return train.DataParallelTrainer(
        train_loop_per_worker=loop,
        train_loop_config={"pkg": pkg.__name__, **kw.pop("config", {})},
        scaling_config=train.ScalingConfig(num_workers=workers),
        run_config=train.RunConfig(name=name, storage_path=str(path),
                                   **run_kw), **kw).fit()


def test_trainer_reports_metrics(pkg, tmp_path):
    result = _fit(pkg, loop_reports, tmp_path, "t1", workers=2)
    assert result.error is None
    assert result.metrics_history == [
        {"step": s, "rank": 0, "world_size": 2} for s in range(3)]


def test_trainer_checkpoint_roundtrip(pkg, tmp_path):
    result = _fit(pkg, loop_checkpoints, tmp_path, "t2")
    assert [m["step"] for m in result.metrics_history] == [0, 1]
    # registered into the run dir with indexed names
    assert os.path.basename(result.checkpoint.path) == "checkpoint_000001"
    assert _read_step(result.checkpoint) == 1
    # resumed from the last checkpoint, nothing is left to run
    resumed = _fit(pkg, loop_checkpoints, tmp_path, "t2b",
                   resume_from_checkpoint=result.checkpoint)
    assert resumed.error is None and resumed.metrics_history == []


def test_failure_recovery_restores_checkpoint(pkg, tmp_path):
    train = _train(pkg)
    marker = str(tmp_path / "crashed_once")
    result = _fit(pkg, loop_crashes_once, tmp_path, "t3",
                  config={"marker": marker},
                  failure_config=train.FailureConfig(max_failures=2))
    assert result.error is None and os.path.exists(marker)
    # crashed at step 2, restored from step 1's checkpoint, finished 2 and 3
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]
    assert _read_step(result.checkpoint) == 3


def test_failure_exhausts_retries(pkg, tmp_path):
    train = _train(pkg)
    with pytest.raises(train.TrainingFailedError) as e:
        _fit(pkg, loop_always_fails, tmp_path, "t4",
             failure_config=train.FailureConfig(max_failures=1))
    assert "after 2 failure(s)" in str(e.value)


def test_dataset_shard_ingest(pkg, tmp_path):
    data = importlib.import_module(pkg.__name__ + ".data")
    result = _fit(pkg, loop_ingest, tmp_path, "t5", workers=2,
                  datasets={"train": data.range(64)})
    assert result.error is None
    assert result.metrics_history == [{"rows": 32}]  # 64 over 2 workers


def test_checkpoint_manager_topk(pkg, tmp_path):
    train = _train(pkg)
    mgr = importlib.import_module(
        pkg.__name__ + ".train.checkpoint").CheckpointManager(
            train.CheckpointConfig(num_to_keep=2,
                                   checkpoint_score_attribute="acc"),
            str(tmp_path))
    for acc in (0.1, 0.9, 0.5, 0.2):
        d = _write_step(0)
        mgr.register(train.Checkpoint(d), {"acc": acc})
    # keeps the best (acc 0.9) and the latest (index 3)
    assert sorted((t.index, t.metrics["acc"]) for t in mgr.tracked) == [
        (1, 0.9), (3, 0.2)]
    assert os.path.basename(mgr.best.path) == "checkpoint_000001"
    assert sorted(p for p in os.listdir(tmp_path)
                  if p.startswith("checkpoint_")) == [
        "checkpoint_000001", "checkpoint_000003"]


def test_checkpoint_storage_uri(pkg, tmp_path):
    train = _train(pkg)
    result = _fit(pkg, loop_uri, f"file://{tmp_path}/bucket", "uri_exp",
                  checkpoint_config=train.CheckpointConfig(num_to_keep=2))
    assert [m["iter"] for m in result.metrics_history] == [0, 1, 2]
    assert result.checkpoint.uri is not None
    with result.checkpoint.as_directory() as d:
        assert open(os.path.join(d, "it.txt")).read() == "2"
    # retention pruned to 2 on the target filesystem
    assert sorted(p for p in os.listdir(tmp_path / "bucket" / "uri_exp")
                  if p.startswith("checkpoint_")) == [
        "checkpoint_000001", "checkpoint_000002"]


# ---------------------------------------------------------------- the port's


#: TorchTrainer is the port's: these tests take the port's runtime only
port_runtime = pytest.mark.parametrize("pkg", ["ray_tpu_torch"],
                                       indirect=True)


def loop_all_reduce(config):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    t = torch.tensor([train.get_context().get_world_rank() + 1.0])
    dist.all_reduce(t)
    train.report({"sum": t.item(), "backend": dist.get_backend(),
                  "world_size": dist.get_world_size()})


@port_runtime
def test_torch_trainer_two_ranks_all_reduce_on_gloo(pkg, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    result = TorchTrainer(
        train_loop_per_worker=loop_all_reduce,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ar", storage_path=str(tmp_path))).fit()
    assert result.metrics_history == [
        {"sum": 3.0, "backend": "gloo", "world_size": 2}]


def loop_tiny_steps(config):
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import config as tcfg
    from ray_tpu_torch.models.convert import train_state_from_numpy
    from ray_tpu_torch.parallel import train_step as tts

    cfg = tcfg.tiny()
    state = train_state_from_numpy(*config["state"], device="cpu")
    step = tts.make_train_step(cfg, None, tts.make_optimizer(**config["opt"]),
                               None, compute_dtype=torch.float32,
                               device="cpu")
    shard = train.get_dataset_shard("train")
    for batch in shard.iter_torch_batches(batch_size=config["rows"]):
        _, metrics = step(state, batch)
        train.report({"loss": metrics["loss"].item(),
                      "tokens": batch["tokens"].tolist(),
                      "device": str(batch["tokens"].device),
                      "mesh": [str(d) for d in
                               train.get_context().mesh().devices.flat]})


@port_runtime
def test_torch_trainer_tiny_steps_match_jax(pkg, tmp_path):
    """One CPU rank, three f32 steps of ``tiny`` from JAX's init state, the
    batches from a dataset shard; JAX's step runs here on the batches the
    rank reports."""
    import ray_tpu_torch.data as tdata
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    jc = jcfg.tiny()
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    mesh = MeshSpec(fsdp=1).build(jax.devices()[:1])
    jopt = jts.make_optimizer(**opt_kw)
    jstate, sh = jts.init_sharded_state(jc, mesh, jopt, seed=0)
    adam = jstate.opt_state[1][0]
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    state = (host(jstate.params), host(adam.mu), host(adam.nu),
             np.asarray(adam.count), np.asarray(jstate.step))
    rows, seq = 4, 32
    tokens = np.random.default_rng(0).integers(
        0, jc.vocab_size, (3 * rows, seq + 1)).astype(np.int32)
    ds = tdata.from_items([{"tokens": r} for r in tokens])

    result = TorchTrainer(
        train_loop_per_worker=loop_tiny_steps,
        train_loop_config={"state": state, "opt": opt_kw, "rows": rows},
        datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="tiny", storage_path=str(tmp_path))).fit()

    history = result.metrics_history
    assert len(history) == 3
    assert {h["device"] for h in history} == {"cpu"}
    assert history[0]["mesh"] == ["cpu"]
    fed = np.array([h["tokens"] for h in history], np.int32)
    np.testing.assert_array_equal(np.sort(fed.reshape(-1, seq + 1), axis=0),
                                  np.sort(tokens, axis=0))
    jstep = jts.make_train_step(jc, mesh, jopt, sh,
                                compute_dtype=jnp.float32)
    for h, batch in zip(history, fed):
        jstate, jm = jstep(jstate, {"tokens": batch})
        assert abs(h["loss"] - float(jm["loss"])) <= LOSS_ATOL, (
            h["loss"], float(jm["loss"]))


@port_runtime
def test_torch_trainer_use_gpu_without_a_card_raises(pkg, tmp_path):
    """The runtime places the worker on the declared card; NCCL's setup
    needs a real one, so ``fit`` raises and nothing runs on the CPU."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    trainer = TorchTrainer(
        train_loop_per_worker=loop_all_reduce,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="gpu", storage_path=str(tmp_path)))
    with pytest.raises(Exception, match="CUDA|NCCL|cuda"):
        trainer.fit()


def test_the_seam_defaults():
    """``use_gpu`` reserves one card per worker, the backend follows the
    workers' cards, tune is not ported, and the peak the observability
    plane divides by is the port's table's."""
    from ray_tpu_torch.models.config import detect_peak_flops
    from ray_tpu_torch.train import (ScalingConfig, StepTracker,
                                     TorchBackendConfig, TorchTrainer)
    assert TorchBackendConfig().backend is None
    assert ScalingConfig(use_gpu=True)._resources_per_worker_not_none == {
        "CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig()._resources_per_worker_not_none == {"CPU": 1.0}
    with pytest.raises(NotImplementedError, match="tune"):
        TorchTrainer(train_loop_per_worker=loop_all_reduce).as_trainable()
    assert detect_peak_flops("cpu") == 1e12
    assert StepTracker._detect_peak() == 1e12   # no CUDA in this process
