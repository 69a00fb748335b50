"""The port's model configs equal the JAX package's, preset by preset."""

import dataclasses

import pytest

from ray_tpu.models import config as jcfg
from ray_tpu_torch.models import config as tcfg


def test_same_presets_and_fields():
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    assert ([f.name for f in dataclasses.fields(tcfg.TransformerConfig)]
            == [f.name for f in dataclasses.fields(jcfg.TransformerConfig)])


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_matches_jax(name):
    j = jcfg.PRESETS[name]()
    t = tcfg.PRESETS[name]()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.head_dim == j.head_dim
    assert t.num_params() == j.num_params()
    assert t.flops_per_token() == j.flops_per_token()
    assert t.flops_per_token(1024) == j.flops_per_token(1024)


def test_tiny_with_experts_matches_jax():
    j, t = jcfg.tiny(experts=4), tcfg.tiny(experts=4)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_params() == j.num_params()
    assert t.flops_per_token(64) == j.flops_per_token(64)
