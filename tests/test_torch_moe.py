"""The port's MoE layer (``ray_tpu_torch/ops/moe.py``) against the JAX
package's ``ray_tpu/ops/moe.py``, on the same numpy inputs in float32.

Routing must give JAX's dispatch tensor exactly (the same pairs kept and
dropped, in the same buffer positions), its combine weights and aux loss
within 1e-6, with k = 1 and 2, a capacity of 1, an overflowing capacity and
router logits built to tie.  ``moe_mlp`` (indices: gather, batched matmuls,
gather) matches JAX's one-hot einsums within 1e-5 with tokens dropped, and
the port's own one-hot version; its gradients in x and all four weights
match ``jax.grad``'s within 1e-4 of each one's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.ops import moe as tmoe

B, S, H, E, M = 2, 12, 16, 4, 24


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H)).astype(np.float32),
            rng.standard_normal((H, E)).astype(np.float32),
            (0.3 * rng.standard_normal((E, H, M))).astype(np.float32),
            (0.3 * rng.standard_normal((E, H, M))).astype(np.float32),
            (0.3 * rng.standard_normal((E, M, H))).astype(np.float32))


def _tie_logits():
    """Rows with equal logits: lax.top_k takes the lower index first."""
    rows = [[1.0, 1.0, 0.0, 0.0], [0.0, 2.0, 2.0, 2.0], [3.0, 3.0, 3.0, 3.0],
            [0.5, 0.0, 0.5, 0.5], [0.0, 0.0, 0.0, 1.0], [2.0, 1.0, 2.0, 1.0]]
    return np.asarray(rows * 4, np.float32)


ROUTING = {  # name -> (logits, k, capacity)
    "k1": (np.random.default_rng(1).standard_normal((24, E)), 1, 24),
    "k2": (np.random.default_rng(2).standard_normal((24, E)), 2, 24),
    "k2-capacity-1": (np.random.default_rng(3).standard_normal((24, E)), 2,
                      1),
    "k2-overflow": (np.random.default_rng(4).standard_normal((24, E)), 2, 5),
    "k1-overflow": (np.random.default_rng(5).standard_normal((24, E)), 1, 3),
    "tie": (_tie_logits(), 2, 5),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_top_k_routing_matches_jax(case):
    logits, k, cap = ROUTING[case]
    logits = logits.astype(np.float32)
    jd, jc, ja = jmoe.top_k_routing(jnp.asarray(logits), k, cap)
    td, tc, ta = tmoe.top_k_routing(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    kept = int(td.sum())
    if "overflow" in case or case == "tie":
        assert 0 < kept < k * logits.shape[0]       # some pairs dropped
    if case == "k2-capacity-1":
        assert kept == E                            # one token per expert
    if case == "tie":
        # torch.topk may order equal values either way; routing may not
        r = tmoe.route(torch.from_numpy(logits), k, cap)
        assert r.expert[:6].tolist() == [[0, 1], [1, 2], [0, 1], [0, 2],
                                         [3, 0], [0, 2]]


# (k, capacity factor): capacities 7, 3, 1 (T = 24, E = 4)
MLP_CASES = [(2, 0.6), (2, 0.25), (1, 0.2), (2, 1.25)]


def _dropped(x, rw, k, cf):
    t = torch.from_numpy(x).reshape(B * S, H)
    cap = tmoe.capacity(cf, k, B, S, E)
    return 1.0 - float(tmoe.route(t @ torch.from_numpy(rw), k,
                                  cap).kept.float().mean())


@pytest.mark.parametrize("k,cf", MLP_CASES)
def test_moe_mlp_matches_jax_and_the_onehot_version(k, cf):
    args = _inputs()
    jo, ja = jmoe.moe_mlp(*map(jnp.asarray, args), k, cf)
    to, ta = tmoe.moe_mlp(*map(torch.from_numpy, args), k, cf)
    oo, oa = tmoe.moe_mlp_onehot(*map(torch.from_numpy, args), k, cf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(to.numpy(), oo.numpy(), atol=1e-5)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6) == float(oa)
    if cf < 1:
        assert _dropped(args[0], args[1], k, cf) > 0


def test_moe_mlp_bf16_matches_the_onehot_version():
    """bf16 compute, as on the card: the gather path against the einsums on
    the same inputs, within 2e-2 of the largest magnitude (chip_smoke.py's
    moe_layer limit)."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(7)]
    out, aux = tmoe.moe_mlp(*args, 2, 0.6)
    ref, ref_aux = tmoe.moe_mlp_onehot(*args, 2, 0.6)
    assert out.dtype == torch.bfloat16
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert float(aux) == float(ref_aux)


def test_moe_mlp_never_builds_the_onehot_tensors(monkeypatch):
    """The gather path reaches neither top_k_routing nor any tensor of T x
    E x C entries."""
    def refuse(*a, **k):
        raise AssertionError("moe_mlp built the [T, E, C] tensors")
    monkeypatch.setattr(tmoe, "top_k_routing", refuse)
    seen = []
    real_zeros = torch.Tensor.new_zeros

    def new_zeros(self, size, *a, **k):
        seen.append(int(np.prod(size)))
        return real_zeros(self, size, *a, **k)
    monkeypatch.setattr(torch.Tensor, "new_zeros", new_zeros)
    x, rw, wg, wi, wo = map(torch.from_numpy, _inputs())
    tmoe.moe_mlp(x, rw, wg, wi, wo, 2, 1.25)
    cap = tmoe.capacity(1.25, 2, B, S, E)
    assert seen and max(seen) < B * S * E * cap


@pytest.mark.parametrize("k,cf", MLP_CASES[:3])
def test_moe_mlp_grads_match_jax(k, cf):
    """d/d(x, router, w_gate, w_in, w_out) of sum(out * g) + 0.3 * aux, with
    tokens dropped: the aux loss's gradient reaches the router and x."""
    args = _inputs(3)
    g = np.random.default_rng(9).standard_normal((B, S, H)).astype(
        np.float32)

    def jloss(*a):
        out, aux = jmoe.moe_mlp(*a, k, cf)
        return jnp.sum(out * jnp.asarray(g)) + 0.3 * aux

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux = tmoe.moe_mlp(*leaves, k, cf)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum() + 0.3 * aux,
                              leaves)
    for name, a, b in zip(("x", "router", "w_gate", "w_in", "w_out"), got,
                          want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max(), name
    assert _dropped(args[0], args[1], k, cf) > 0
