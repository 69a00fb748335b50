"""The port's data library (``ray_tpu_torch.data``) against the JAX
package's.

``tests/test_data.py``'s pipelines (map and filter, ``map_batches``, sort
and a seeded shuffle, ``groupby``, ``streaming_split`` with equal rows, the
parquet and CSV round trips, ``iter_torch_batches``, a seeded local
shuffle buffer) run through each runtime in turn (this file's fixture) and
must give equal rows, in the same order where the pipeline fixes one.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from ray_tpu.utils.testing import CPU_WORKER_ENV

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: each runtime's shared-memory arena: the pipelines move a few kB
STORE_BYTES = 64 << 20


def flow_map_filter(pkg, rd, tmp):
    ds = rd.from_items([{"x": i} for i in range(20)], parallelism=2)
    out = (ds.map(lambda r: {"x": r["x"] * 2})
             .filter(lambda r: r["x"] % 4 == 0))
    return sorted(r["x"] for r in out.take_all())


def flow_map_batches(pkg, rd, tmp):
    ds = rd.range(32, parallelism=2)
    out = ds.map_batches(lambda b: {"id": b["id"] * 2}, batch_size=8)
    return sorted(r["id"] for r in out.take_all())


def flow_sort_and_shuffle(pkg, rd, tmp):
    ds = rd.from_items([{"v": i} for i in [5, 3, 8, 1, 9, 2, 7, 0, 6, 4]],
                       parallelism=3)
    return ([r["v"] for r in ds.sort("v").take_all()],
            [r["v"] for r in ds.sort("v", descending=True).take_all()],
            [r["v"] for r in ds.random_shuffle(seed=7).take_all()])


def flow_groupby(pkg, rd, tmp):
    ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(12)],
                       parallelism=3)
    return sorted((r["k"], r["sum(v)"])
                  for r in ds.groupby("k").sum("v").take_all())


def flow_streaming_split_equal(pkg, rd, tmp):
    its = rd.range(30, parallelism=3).streaming_split(2, equal=True)

    @pkg.remote
    def count_rows(it):
        return sum(len(b["id"]) for b in it.iter_batches(batch_size=7))

    return pkg.get([count_rows.remote(its[0]), count_rows.remote(its[1])],
                   timeout=60)


def flow_parquet_roundtrip(pkg, rd, tmp):
    path = os.path.join(tmp, "pq")
    files = rd.range(50, parallelism=2).write_parquet(path)
    back = rd.read_parquet(path)
    return (len(files), all(f.endswith(".parquet") for f in files),
            back.count(), sorted(r["id"] for r in back.take_all()))


def flow_csv_roundtrip(pkg, rd, tmp):
    path = os.path.join(tmp, "csv")
    rd.from_items([{"a": i, "b": f"s{i}"} for i in range(10)],
                  parallelism=1).write_csv(path)
    return sorted((r["a"], r["b"]) for r in rd.read_csv(path).take_all())


def flow_iter_torch_batches(pkg, rd, tmp):
    rows = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    ds = rd.from_items([{"tokens": r} for r in rows], parallelism=1)
    return [(type(b["tokens"]).__name__, str(b["tokens"].dtype),
             b["tokens"].tolist())
            for b in ds.iter_torch_batches(batch_size=4, device="cpu")]


def flow_local_shuffle(pkg, rd, tmp):
    ds = rd.range(64, parallelism=2)
    return [int(v) for b in ds.iter_batches(
        batch_size=16, local_shuffle_buffer_size=16, local_shuffle_seed=3)
        for v in b["id"]]


FLOWS = {name[len("flow_"):]: fn for name, fn in globals().items()
         if name.startswith("flow_")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every pipeline through each runtime in turn: {package: {pipeline:
    (status, value)}}."""
    out = {}
    for name in PACKAGES:
        pkg = importlib.import_module(name)
        rd = importlib.import_module(name + ".data")
        extra = ({"worker_env": dict(CPU_WORKER_ENV)} if name == "ray_tpu"
                 else {})
        pkg.init(num_cpus=4, object_store_memory=STORE_BYTES, **extra)
        ctx = rd.DataContext.get_current()
        old = ctx.max_tasks_in_flight_per_op
        ctx.max_tasks_in_flight_per_op = 4
        try:
            out[name] = {}
            for flow, fn in FLOWS.items():
                tmp = str(tmp_path_factory.mktemp(f"{name}_{flow}"))
                try:
                    out[name][flow] = ("ok", fn(pkg, rd, tmp))
                except Exception as e:  # noqa: BLE001 - recorded, asserted
                    out[name][flow] = ("raised", f"{type(e).__name__}: {e}")
        finally:
            ctx.max_tasks_in_flight_per_op = old
            pkg.shutdown()
    return out


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_pipeline_matches_reference(results, flow):
    ref, port = results["ray_tpu"][flow], results["ray_tpu_torch"][flow]
    assert ref[0] == "ok", ref
    assert port == ref


def test_pipeline_values(results):
    """The reference's own results are the right ones, so the comparison
    above holds the port to something."""
    r = {k: v[1] for k, v in results["ray_tpu"].items()}
    assert r["map_filter"] == [i * 2 for i in range(20) if i * 2 % 4 == 0]
    assert r["map_batches"] == [i * 2 for i in range(32)]
    asc, desc, shuffled = r["sort_and_shuffle"]
    assert asc == list(range(10)) and desc == list(range(9, -1, -1))
    assert sorted(shuffled) == list(range(10)) and shuffled != asc
    assert r["groupby"] == [(k, float(sum(range(k, 12, 3))))
                            for k in range(3)]
    assert r["streaming_split_equal"] == [15, 15]
    assert r["parquet_roundtrip"][1:] == (True, 50, list(range(50)))
    assert r["csv_roundtrip"] == [(i, f"s{i}") for i in range(10)]
    rows = np.arange(24).reshape(8, 3).tolist()
    assert r["iter_torch_batches"] == [
        ("Tensor", str(torch.int32), rows[:4]),
        ("Tensor", str(torch.int32), rows[4:])]
    assert sorted(r["local_shuffle"]) == list(range(64))
    assert r["local_shuffle"] != list(range(64))
