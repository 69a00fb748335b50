"""Decoder-only transformer: one implementation for GPT-2 / Llama-3 / Mixtral.

Counterpart of ``ray_tpu/models/transformer.py``:
* Params are a plain nested dict with the JAX tree's keys; every block weight
  is stacked ``[L, ...]``, so a JAX tree converts leaf by leaf
  (``models/convert.py``).
* Layers run as a Python loop over ``L`` where the JAX package scans.  A
  layer is a list of steps over named values (``_layer_steps``), run by
  ``models/remat.py``, which keeps for the backward what the remat policy
  saves (the JAX package's ``checkpoint_name`` tags, or every product's
  output under ``"dots"``) and recomputes the rest.
* Norms compute in f32 and cast back; RoPE rotates halves, not interleaved
  pairs; GELU is the tanh approximation (``jax.nn.gelu``'s default).
* Attention: ``attention_impl`` picks plain, flash (kernels B1-B3), splash
  (kernel B4, with the logit softcap) or ``mha``'s own choice ("auto");
  splash that declines a shape falls back to ``mha``, as in JAX.
* The loss: ``causal_lm_loss`` with the blockwise LM head and cross entropy
  (``chunked_cross_entropy``, a ``torch.autograd.Function`` whose backward
  recomputes one chunk's logits at a time).
* MoE (``num_experts > 1``): the block's MLP is ``ops/moe.py``'s
  ``moe_mlp``, one step whose residuals carry no names (the JAX package
  tags nothing inside it), so every remat policy replays it; the blocks'
  aux losses are averaged into ``moe_aux_loss``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops import moe as moe_ops
from ..ops.attention import attend, flash_kernel_takes, mha
from . import remat as rm
from .config import TransformerConfig

Params = Dict[str, Any]

# The names the JAX package tags with checkpoint_name: q, k, v after RoPE,
# the attention output, flash's lse (inside its vjp), the SwiGLU products
# and the GELU MLP's pre-activation.  "save_acts" keeps all of them,
# "save_mlp" the MLP's.
REMAT_SAVE_NAMES = ("attn_q", "attn_k", "attn_v", "attn_out", "attn_lse",
                    "mlp_gate", "mlp_up", "mlp_pre")
# flash attention's residuals (q, k, v, out, lse) carry these names
FLASH_RESIDUALS = ("attn_q", "attn_k", "attn_v", "attn_out", "attn_lse")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: TransformerConfig,
                dtype=torch.float32) -> Params:
    """Random params with the JAX package's keys and shapes, drawn from
    ``generator`` on its device.  (Values differ from the JAX package's
    draws; tests convert JAX params instead.)"""
    h, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, m, L = cfg.num_heads, cfg.num_kv_heads, cfg.mlp_size, cfg.num_layers
    dev = generator.device

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return x.mul_(std)

    def dense(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def norm_p():
        p = {"scale": torch.ones((L, h), dtype=dtype, device=dev)}
        if not cfg.use_rmsnorm:
            p["bias"] = zeros((L, h))
        return p

    blocks: Params = {
        "attn_norm": norm_p(),
        "attn": {
            "wq": dense((L, h, nh * hd), h),
            "wk": dense((L, h, nkv * hd), h),
            "wv": dense((L, h, nkv * hd), h),
            "wo": dense((L, nh * hd, h), nh * hd),
        },
        "mlp_norm": norm_p(),
    }
    if not cfg.use_rmsnorm or cfg.use_qkv_bias:
        # GPT-2 style (all biases) or Qwen-2 style (Q/K/V biases only)
        blocks["attn"]["bq"] = zeros((L, nh * hd))
        blocks["attn"]["bk"] = zeros((L, nkv * hd))
        blocks["attn"]["bv"] = zeros((L, nkv * hd))
    if not cfg.use_rmsnorm:
        blocks["attn"]["bo"] = zeros((L, h))
    if cfg.num_experts > 1:
        e = cfg.num_experts
        blocks["moe"] = {
            "router": dense((L, h, e), h),
            "w_gate": dense((L, e, h, m), h),
            "w_in": dense((L, e, h, m), h),
            "w_out": dense((L, e, m, h), m),
        }
    else:
        mlp: Params = {"w_in": dense((L, h, m), h),
                       "w_out": dense((L, m, h), m)}
        if cfg.use_swiglu:
            mlp["w_gate"] = dense((L, h, m), h)
        else:
            mlp["b_in"] = zeros((L, m))
            mlp["b_out"] = zeros((L, h))
        blocks["mlp"] = mlp

    params: Params = {
        "embed": {"tokens": normal((cfg.vocab_size, h), 0.02)},
        "blocks": blocks,
        "final_norm": {"scale": torch.ones((h,), dtype=dtype, device=dev)},
    }
    if not cfg.use_rope:
        params["embed"]["pos"] = normal((cfg.max_seq_len, h), 0.01)
    if not cfg.use_rmsnorm:
        params["final_norm"]["bias"] = zeros((h,))
    if not cfg.tied_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), h)
    return params


def unbind_layers(blocks: Params, num_layers: int) -> List[Params]:
    """Every layer's slice of the stacked block params (views, no copies),
    from one ``torch.unbind`` per leaf, whose backward stacks the L
    gradients once."""
    layers: List[Params] = [{} for _ in range(num_layers)]
    for k, v in blocks.items():
        parts = (unbind_layers(v, num_layers) if isinstance(v, dict)
                 else torch.unbind(v))
        for lp, part in zip(layers, parts):
            lp[k] = part
    return layers


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    x32 = x.float()
    if cfg.use_rmsnorm:
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                + cfg.norm_eps)
        return (x32 * p["scale"].float()).to(x.dtype)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    x32 = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
    return (x32 * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos/sin of ``positions[..., None] * freqs`` in f32, [..., D/2]."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    # halves, not interleaved pairs (the JAX package's convention)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          inverse: bool = False):
    """x: [B, S, H, D]; positions: [S].  ``inverse`` rotates back (the
    transpose, which is the rotation's backward)."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    sin = -sin if inverse else sin
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _attention_fn(cfg: TransformerConfig, seq: int, is_cuda: bool,
                  dtype: torch.dtype):
    """The attention step on ``dtype`` inputs: (q, k, v) -> out, and the
    names its residuals carry (flash's are tagged inside its vjp in JAX;
    splash passes no ``residual_checkpoint_name``, so its residuals are
    unnamed)."""
    impl, causal = cfg.attention_impl, cfg.causal
    cap = cfg.attn_logit_softcap

    def auto(q, k, v):
        return mha(q, k, v, causal=causal, logit_softcap=cap)

    if impl == "splash":
        from ..ops.splash_attention import splash_mha

        def splash(q, k, v):
            out = splash_mha(q, k, v, causal=causal, logit_softcap=cap)
            return auto(q, k, v) if out is None else out  # declined
        return splash, None
    if impl == "plain":
        return (lambda q, k, v: attend(q, k, v, causal=causal,
                                       logit_softcap=cap)), None
    # the flash kernel takes bf16 only; on CPU tensors flash_attention runs
    # its plain version, which takes any dtype
    if impl == "flash" and cap == 0.0 and (
            not is_cuda or dtype == torch.bfloat16):
        from ..ops.flash_attention import flash_attention
        return (lambda q, k, v: flash_attention(q, k, v, causal=causal),
                FLASH_RESIDUALS)
    # "auto", or flash declined a softcap or a dtype: mha picks flash or
    # plain
    names = (FLASH_RESIDUALS
             if flash_kernel_takes(is_cuda, seq, cfg.head_dim, cap, dtype)
             else None)
    return auto, names


def _bias_grad(g: torch.Tensor, dtype) -> torch.Tensor:
    return g.sum((0, 1)).to(dtype)


def _norm_step(name: str, x: str, out: str, lp: Params,
               cfg: TransformerConfig) -> rm.Step:
    keys = tuple(sorted(lp[name]))       # ("bias", "scale") or ("scale",)

    def fn(x, *p):
        return _norm(x, dict(zip(keys, p)), cfg)
    return rm.Step(name, fn, (x, *(f"{name}.{k}" for k in keys)), (out,))


def _layer_steps(lp: Params, cfg: TransformerConfig, positions: torch.Tensor,
                 lead: Tuple[int, int], is_cuda: bool,
                 dtype: torch.dtype) -> List[rm.Step]:
    """One transformer block on ``dtype`` activations as steps over named
    values: the input "x", the layer's params by path ("attn.wq", ...), the
    output "y" (and with MoE the layer's aux loss "moe_aux").  Values named
    as in the JAX package's checkpoint_name tags are kept by the policies
    that save those names."""
    b, s = lead
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = lp["attn"]
    theta = cfg.rope_theta
    qkv_bias = "bq" in attn

    def qkv(qd, kd, vd, *bias):
        if qkv_bias:
            qd, kd, vd = (t + bb.to(t.dtype) for t, bb in zip((qd, kd, vd),
                                                              bias))
        q, k, v = (qd.reshape(b, s, nh, hd), kd.reshape(b, s, nkv, hd),
                   vd.reshape(b, s, nkv, hd))
        if cfg.use_rope:
            q, k = _rope(q, positions, theta), _rope(k, positions, theta)
        return q, k, v

    def qkv_bwd(gq, gk, gv):
        if cfg.use_rope:
            gq = _rope(gq, positions, theta, inverse=True)
            gk = _rope(gk, positions, theta, inverse=True)
        g = [t.reshape(b, s, -1) for t in (gq, gk, gv)]
        if qkv_bias:
            g += [_bias_grad(t, attn["bq"].dtype) for t in g]
        return g

    bo = ("attn.bo",) if "bo" in attn else ()
    attention, residual_names = _attention_fn(cfg, s, is_cuda, dtype)
    steps = [
        _norm_step("attn_norm", "x", "attn_in", lp, cfg),
        rm.Step("wq", rm.dot, ("attn_in", "attn.wq"), ("q_dot",), rm.DOT),
        rm.Step("wk", rm.dot, ("attn_in", "attn.wk"), ("k_dot",), rm.DOT),
        rm.Step("wv", rm.dot, ("attn_in", "attn.wv"), ("v_dot",), rm.DOT),
        rm.Step("qkv", qkv, ("q_dot", "k_dot", "v_dot")
                + (("attn.bq", "attn.bk", "attn.bv") if qkv_bias else ()),
                ("attn_q", "attn_k", "attn_v"), rm.LINEAR, qkv_bwd),
        rm.Step("attention", attention, ("attn_q", "attn_k", "attn_v"),
                ("attn_out",), residual_names=residual_names),
        rm.Step("wo", rm.dot, ("attn_out", "attn.wo"), ("attn_proj",),
                rm.DOT),
        rm.Step("attn_residual", _add, ("x", "attn_proj", *bo), ("x2",),
                rm.LINEAR, _add_bwd(attn.get("bo"))),
        _norm_step("mlp_norm", "x2", "mlp_in", lp, cfg),
        *(_moe_steps(cfg) if cfg.num_experts > 1
          else _mlp_steps(lp["mlp"], cfg)),
        rm.Step("mlp_residual", _add, ("x2", "mlp_out"), ("y",), rm.LINEAR,
                _add_bwd(None)),
    ]
    return steps


def _add(x, y, *bias):
    """The residual add x + (y + bias), the bias optional."""
    return x + (_bias_add(y, bias[0]) if bias else y)


def _add_bwd(bias: Optional[torch.Tensor]):
    if bias is None:
        return lambda g: (g, g)
    return lambda g: (g, g, _bias_grad(g, bias.dtype))


def _bias_add(y, bias):
    return y + bias.to(y.dtype)


def _bias_add_bwd(bias: torch.Tensor):
    return lambda g: (g, _bias_grad(g, bias.dtype))


def _mlp_steps(mlp: Params, cfg: TransformerConfig) -> List[rm.Step]:
    """The MLP: "mlp_in" (the norm'd input) -> "mlp_out"."""
    if cfg.use_swiglu:
        return [
            rm.Step("w_gate", rm.dot, ("mlp_in", "mlp.w_gate"),
                    ("mlp_gate",), rm.DOT),
            rm.Step("w_in", rm.dot, ("mlp_in", "mlp.w_in"), ("mlp_up",),
                    rm.DOT),
            rm.Step("mlp_act", lambda gate, up: F.silu(gate) * up,
                    ("mlp_gate", "mlp_up"), ("mlp_hidden",)),
            rm.Step("w_out", rm.dot, ("mlp_hidden", "mlp.w_out"),
                    ("mlp_out",), rm.DOT),
        ]
    return [
        rm.Step("w_in", rm.dot, ("mlp_in", "mlp.w_in"), ("mlp_up_dot",),
                rm.DOT),
        rm.Step("mlp_bias", _bias_add, ("mlp_up_dot", "mlp.b_in"),
                ("mlp_pre",), rm.LINEAR, _bias_add_bwd(mlp["b_in"])),
        rm.Step("mlp_act", lambda pre: F.gelu(pre, approximate="tanh"),
                ("mlp_pre",), ("mlp_hidden",)),
        rm.Step("w_out", rm.dot, ("mlp_hidden", "mlp.w_out"),
                ("mlp_proj",), rm.DOT),
        rm.Step("mlp_bias_out", _bias_add, ("mlp_proj", "mlp.b_out"),
                ("mlp_out",), rm.LINEAR, _bias_add_bwd(mlp["b_out"])),
    ]


def _moe_steps(cfg: TransformerConfig) -> List[rm.Step]:
    """The sparse MLP: "mlp_in" -> "mlp_out" and the aux loss "moe_aux".
    One step with unnamed residuals: every remat policy replays it (under
    "dots" JAX keeps its einsums' outputs instead; the values are the
    same)."""
    def moe(x, router, w_gate, w_in, w_out):
        return moe_ops.moe_mlp(x, router, w_gate, w_in, w_out,
                               cfg.experts_per_token,
                               cfg.expert_capacity_factor)
    return [rm.Step("moe", moe, ("mlp_in", "moe.router", "moe.w_gate",
                                 "moe.w_in", "moe.w_out"),
                    ("mlp_out", "moe_aux"))]


def _mlp_block(x, p, cfg: TransformerConfig):
    """The MLP half of a block alone (the decode path's): norm'd input ->
    the MLP's output before its output bias ``b_out``, which the decode
    path adds once after summing the tp shards' outputs."""
    steps = _mlp_steps(p, cfg)
    if "b_out" in p:
        steps = steps[:-1]                  # all but "mlp_bias_out"
    values = rm.forward(steps, {"mlp_in": x, **_flat(p, "mlp.")})
    return values[steps[-1].outs[0]]


def _flat(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def block_forward(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
                  positions: torch.Tensor,
                  policy: Union[rm.SavePolicy, None] = None):
    """One transformer block: x [B, S, H] -> (x, moe aux loss).  ``policy``
    (see ``remat_policy``) says what its backward keeps; None keeps all."""
    steps = _layer_steps(lp, cfg, positions, x.shape[:2], x.is_cuda,
                         x.dtype)
    values = {"x": x, **_flat(lp)}
    if cfg.num_experts > 1:
        return rm.run(steps, values, ("y", "moe_aux"), policy)
    y, = rm.run(steps, values, ("y",), policy)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token (+ learned positional) embedding: [B, S] -> [B, S, H]."""
    x = params["embed"]["tokens"][tokens.long()].to(compute_dtype)
    if not cfg.use_rope:
        s = tokens.shape[1]
        x = x + params["embed"]["pos"][:s][None].to(compute_dtype)
    return x


def remat_policy(remat: Union[bool, str, None]
                 ) -> Tuple[bool, Optional[rm.SavePolicy]]:
    """Map a remat spec to (enabled, what each layer keeps for its
    backward); the rest is recomputed there (``models/remat.py``).

    - False/None: no rematerialization (policy None: keep everything);
    - True / "full": keep only each layer's input (``nothing_saveable``);
    - "save_acts": keep the named values of ``REMAT_SAVE_NAMES`` (the
      backward replays norms, elementwise work, the output projection and
      any attention whose residuals are unnamed, such as splash's);
    - "save_mlp": keep only the MLP's named values;
    - "dots": keep every matrix product's output (``dots_saveable``).
    """
    if remat is None or remat is False:
        return False, None
    if remat is True or remat == "full":
        return True, rm.SavePolicy()
    if remat == "save_acts":
        return True, rm.SavePolicy(names=frozenset(REMAT_SAVE_NAMES))
    if remat == "save_mlp":
        return True, rm.SavePolicy(
            names=frozenset(("mlp_gate", "mlp_up", "mlp_pre")))
    if remat == "dots":
        return True, rm.SavePolicy(dots=True)
    raise ValueError(f"unknown remat policy {remat!r}")


def apply_trunk(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                compute_dtype=torch.bfloat16,
                remat: Union[bool, str, None] = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (final hidden states [B, S, H], aux dict).

    The trunk stops before the LM head so the loss can run the head
    blockwise (``chunked_cross_entropy``).  ``remat`` (``remat_policy``)
    says what each layer keeps for the backward; the backward recomputes
    the rest, the attention forward too when its residuals are not kept."""
    _, policy = remat_policy(remat)
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = []
    for lp in unbind_layers(params["blocks"], cfg.num_layers):
        x, a = block_forward(x, lp, cfg, positions, policy)
        aux.append(a)
    x = _norm(x, params["final_norm"], cfg)
    return x, {"moe_aux_loss": torch.stack(aux).mean()}


def lm_head_weight(params: Params, cfg: TransformerConfig,
                   dtype) -> torch.Tensor:
    """[H, V] head weight (tied embedding transpose or separate lm_head)."""
    if cfg.tied_embeddings:
        return params["embed"]["tokens"].T.to(dtype)
    return params["lm_head"].to(dtype)


def apply(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
          compute_dtype=torch.bfloat16,
          remat: Union[bool, str, None] = False
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (logits [B, S, V] f32, aux dict)."""
    x, aux = apply_trunk(params, tokens, cfg, compute_dtype, remat=remat)
    logits = x @ lm_head_weight(params, cfg, x.dtype)
    return logits.float(), aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32 sums of the operands' values (JAX's
    ``preferred_element_type=f32``).  bf16 operands on the card go to one
    cuBLAS product with an f32 output; elsewhere the operands widen to f32
    exactly first."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def chunked_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                          targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Blockwise LM head + softmax cross entropy: peak memory O(B*chunk*V)
    instead of O(B*S*V).

    x: [B, S, H] (compute dtype), w: [H, V], targets: [B, S] int
    -> nll [B, S] f32.  Logits are f32 sums of the operands.  The forward
    keeps only the per-token lse; the backward recomputes one chunk's logits
    at a time and forms dlogits = (softmax - onehot) * g, cast to x's dtype
    before both products, with dw summed in f32.  A chunk that does not
    divide S shrinks to the largest divisor of S below it.
    """
    s = x.shape[1]
    if s % chunk != 0:
        chunk = next((c for c in range(min(chunk, s), 0, -1) if s % c == 0), s)
    return _ChunkedCE.apply(x, w, targets, chunk)


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        b, s, h = x.shape
        nll = torch.empty((b, s), dtype=torch.float32, device=x.device)
        lse = torch.empty_like(nll)
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk].reshape(-1, h)
            logits = _dot_f32(xc, w)                              # [B*C, V]
            l = torch.logsumexp(logits, dim=-1)
            tc = targets[:, c0:c0 + chunk].reshape(-1, 1).long()
            ll = logits.gather(-1, tc)[:, 0]
            lse[:, c0:c0 + chunk] = l.view(b, -1)
            nll[:, c0:c0 + chunk] = (l - ll).view(b, -1)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, h = x.shape
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk].reshape(-1, h)
            logits = _dot_f32(xc, w)
            p = torch.exp(logits - lse[:, c0:c0 + chunk].reshape(-1, 1))
            tc = targets[:, c0:c0 + chunk].reshape(-1, 1).long()
            p.scatter_add_(-1, tc, torch.full_like(tc, -1, dtype=p.dtype))
            dlog = (p * g[:, c0:c0 + chunk].reshape(-1, 1)).to(x.dtype)
            dx[:, c0:c0 + chunk] = (dlog @ w.T).view(b, -1, h)
            dw += _dot_f32(xc.T, dlog)
        return dx, dw.to(w.dtype), None, None


def causal_lm_loss(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: TransformerConfig, compute_dtype=torch.bfloat16,
                   moe_aux_weight: float = 0.01,
                   remat: Union[bool, str, None] = False,
                   loss_chunk: Optional[int] = 0):
    """batch: {"tokens": [B, S+1]} or {"tokens", "targets"}, optionally
    "loss_mask" [B, S].  Returns (loss, metrics).

    loss_chunk: sequence-chunk size for the blockwise LM head.  0 (default)
    chunks at 512 when the full logits tensor would be large
    (S*V > 2**25 elements); None disables; an int forces that chunk size.
    """
    if "targets" in batch:
        tokens, targets = batch["tokens"], batch["targets"]
    else:
        tokens, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    s = tokens.shape[1]
    if loss_chunk == 0:
        loss_chunk = 512 if s * cfg.vocab_size > 2 ** 25 else None
    x, aux = apply_trunk(params, tokens, cfg, compute_dtype, remat=remat)
    if loss_chunk:
        w = lm_head_weight(params, cfg, x.dtype)
        nll = chunked_cross_entropy(x, w, targets, min(loss_chunk, s))
    else:
        logits = (x @ lm_head_weight(params, cfg, x.dtype)).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
        denom = torch.full((), nll.numel(), dtype=torch.int32,
                           device=nll.device)
    else:
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
        denom = mask.sum()
    total = loss + moe_aux_weight * aux["moe_aux_loss"]
    return total, {"loss": loss, "moe_aux_loss": aux["moe_aux_loss"],
                   "tokens": denom}
