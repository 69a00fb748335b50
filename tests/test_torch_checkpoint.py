"""Checkpoint IO of the port (``ray_tpu_torch.train``): ``save_pytree`` and
``load_pytree`` round-trip a one-device and a sharded ``TrainState``, and a
state saved on one mesh resumes on another mesh, or on one device, and
steps as the uninterrupted run does.

The states are the port's own, float32 on ``tiny()`` with every shard on
the CPU (``"cpu"`` named once per device); the file imports no JAX.  A run
resumed on another mesh sums its f32 gradients in another order, so its
losses are held within 1e-6 relative of the uninterrupted run's; on the
mesh that saved, they are equal.
"""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import load_pytree, save_pytree
from ray_tpu_torch.train.torch_utils import STATE_FILE

CFG = tiny()
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _mesh(n, **spec):
    return tmesh.MeshSpec(**spec).build(["cpu"] * n)


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return {"tokens": rng.integers(0, CFG.vocab_size, (4, 17))
            .astype(np.int32)}


def _step(mesh):
    return tts.make_train_step(CFG, mesh, tts.make_optimizer(**OPT), None,
                               compute_dtype=torch.float32,
                               device=None if mesh else "cpu")


def _init(mesh):
    state, _ = tts.init_sharded_state(CFG, mesh, tts.make_optimizer(**OPT),
                                      seed=0,
                                      device=None if mesh else "cpu")
    return state


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _whole(leaf):
    return leaf.full() if isinstance(leaf, tmesh.Sharded) else leaf.detach()


def _state_leaves(state):
    yield from (("params." + p, v) for p, v in _flat(state.params))
    yield from (("opt." + p, v) for p, v in _flat(state.opt_state))
    yield "step", state.step


@pytest.mark.parametrize("spec", [None, dict(fsdp=2, tp=2)],
                         ids=["one_device", "fsdp2_tp2"])
def test_round_trip(tmp_path, spec):
    """Saved after a step and loaded onto the same placement: every leaf
    equal, the params requiring grad, each part on its device."""
    mesh = None if spec is None else _mesh(4, **spec)
    state, _ = _step(mesh)(_init(mesh), _batch(0))
    assert save_pytree(str(tmp_path), state) == str(tmp_path)
    like = state if mesh is None else tts.state_shardings(CFG, mesh)
    back = (load_pytree(str(tmp_path), target=like) if mesh is None
            else load_pytree(str(tmp_path), shardings=like))
    assert isinstance(back, tts.TrainState)
    got = dict(_state_leaves(back))
    for path, leaf in _state_leaves(state):
        assert torch.equal(_whole(got[path]), _whole(leaf)), path
        if mesh is not None:
            assert [p.device for p in got[path].parts] == mesh.device_list
    for leaf in tts._leaves(back.params):
        parts = leaf.parts if mesh is not None else [leaf]
        assert all(p.requires_grad and p.is_leaf for p in parts)
    # no target: the whole leaves on the host
    host = load_pytree(str(tmp_path))
    assert all(t.device.type == "cpu" and t.shape == _whole(leaf).shape
               for (_, t), (_, leaf) in zip(_state_leaves(host),
                                            _state_leaves(state)))


def test_resume_on_other_meshes_steps_as_the_uninterrupted_run(tmp_path):
    """fsdp=2,tp=2 for 2 steps, saved; dp=2,tp=2 for 1, saved; one device
    for 1: the losses are the uninterrupted fsdp=2,tp=2 run's."""
    first = _mesh(4, fsdp=2, tp=2)
    state, step = _init(first), _step(first)
    want = []
    for i in range(4):
        state, m = step(state, _batch(i))
        want.append(float(m["loss"]))

    state, got = _init(first), []
    for i in range(2):
        state, m = step(state, _batch(i))
        got.append(float(m["loss"]))
    save_pytree(str(tmp_path / "a"), state)
    second = _mesh(4, dp=2, tp=2, fsdp=1)
    state = load_pytree(str(tmp_path / "a"),
                        shardings=tts.state_shardings(CFG, second))
    state, m = _step(second)(state, _batch(2))
    got.append(float(m["loss"]))
    save_pytree(str(tmp_path / "b"), state)
    state = load_pytree(str(tmp_path / "b"), target=_init(None))
    state, m = _step(None)(state, _batch(3))
    got.append(float(m["loss"]))
    assert got[:2] == want[:2]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert int(state.step) == 4 and int(state.opt_state["count"]) == 4


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_pytree(str(tmp_path / "nothing"))


def test_the_file_is_plain_dicts_of_host_tensors(tmp_path):
    """``state.pt`` loads with ``torch.load(weights_only=True)``: dicts of
    CPU tensors and a kind tag, whole leaves of a sharded state."""
    mesh = _mesh(4, fsdp=2, tp=2)
    state = _init(mesh)
    save_pytree(str(tmp_path), state)
    raw = torch.load(os.path.join(str(tmp_path), STATE_FILE),
                     weights_only=True)
    assert raw["__kind__"] == "TrainState"
    assert set(raw) == {"__kind__", "params", "opt_state", "step"}
    for path, leaf in _flat(raw["params"]):
        want = dict(_flat(state.params))[path]
        assert leaf.device.type == "cpu" and leaf.shape == want.shape
        assert torch.equal(leaf, want.full())


@pytest.mark.cuda
def test_a_mesh_over_the_cards_puts_one_shard_on_each():
    """``MeshSpec(...).build()`` takes every card: with two or more, each
    device of the mesh is its own card and each shard of a state lives on
    its device."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cards = tmesh.cuda_devices()
    mesh = tmesh.MeshSpec(fsdp=len(cards)).build()
    assert mesh.device_list == cards
    state, _ = tts.init_sharded_state(CFG, mesh, tts.make_optimizer(**OPT))
    for leaf in tts._leaves(state.params):
        assert [p.device for p in leaf.parts] == cards
