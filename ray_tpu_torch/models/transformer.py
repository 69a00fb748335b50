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
* Over a device mesh (``mesh=``; the section at the end): every device
  runs its shard of each layer, with the all-gathers and sums the
  reference's sharding rules imply, and under sp the ring, inside the
  layer's remat steps.
* MoE (``num_experts > 1``): the block's MLP is ``ops/moe.py``'s
  ``moe_mlp``, one step whose residuals carry no names (the JAX package
  tags nothing inside it), so every remat policy replays it; the blocks'
  aux losses are averaged into ``moe_aux_loss``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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

def init_params(generator: Optional[torch.Generator], cfg: TransformerConfig,
                dtype=torch.float32, place=None) -> Params:
    """Random params with the JAX package's keys and shapes, drawn from
    ``generator`` on its device.  (Values differ from the JAX package's
    draws; tests convert JAX params instead.)  ``place(path, leaf)``
    (optional; paths as ``"blocks.attn.wq"``) takes each leaf as soon as
    it is made, in draw order, and returns what the tree holds: the mesh's
    init cuts each leaf into its devices' blocks there and drops it.
    ``generator=None`` gives the tree's shapes only, as tensors on the
    ``meta`` device (the counterpart of ``jax.eval_shape`` on the init)."""
    h, hd = cfg.hidden_size, cfg.head_dim
    nh, nkv, m, L = cfg.num_heads, cfg.num_kv_heads, cfg.mlp_size, cfg.num_layers
    dev = generator.device if generator is not None else torch.device("meta")
    put = place or (lambda path, leaf: leaf)

    def normal(path, shape, std):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return put(path, x.mul_(std))

    def dense(path, shape, fan_in):
        return normal(path, shape, fan_in ** -0.5)

    def zeros(path, shape):
        return put(path, torch.zeros(shape, dtype=dtype, device=dev))

    def ones(path, shape):
        return put(path, torch.ones(shape, dtype=dtype, device=dev))

    def norm_p(name, shape):
        p = {"scale": ones(f"{name}.scale", shape)}
        if not cfg.use_rmsnorm:
            p["bias"] = zeros(f"{name}.bias", shape)
        return p

    blocks: Params = {
        "attn_norm": norm_p("blocks.attn_norm", (L, h)),
        "attn": {
            "wq": dense("blocks.attn.wq", (L, h, nh * hd), h),
            "wk": dense("blocks.attn.wk", (L, h, nkv * hd), h),
            "wv": dense("blocks.attn.wv", (L, h, nkv * hd), h),
            "wo": dense("blocks.attn.wo", (L, nh * hd, h), nh * hd),
        },
        "mlp_norm": norm_p("blocks.mlp_norm", (L, h)),
    }
    if not cfg.use_rmsnorm or cfg.use_qkv_bias:
        # GPT-2 style (all biases) or Qwen-2 style (Q/K/V biases only)
        blocks["attn"]["bq"] = zeros("blocks.attn.bq", (L, nh * hd))
        blocks["attn"]["bk"] = zeros("blocks.attn.bk", (L, nkv * hd))
        blocks["attn"]["bv"] = zeros("blocks.attn.bv", (L, nkv * hd))
    if not cfg.use_rmsnorm:
        blocks["attn"]["bo"] = zeros("blocks.attn.bo", (L, h))
    if cfg.num_experts > 1:
        e = cfg.num_experts
        blocks["moe"] = {
            "router": dense("blocks.moe.router", (L, h, e), h),
            "w_gate": dense("blocks.moe.w_gate", (L, e, h, m), h),
            "w_in": dense("blocks.moe.w_in", (L, e, h, m), h),
            "w_out": dense("blocks.moe.w_out", (L, e, m, h), m),
        }
    else:
        mlp: Params = {"w_in": dense("blocks.mlp.w_in", (L, h, m), h),
                       "w_out": dense("blocks.mlp.w_out", (L, m, h), m)}
        if cfg.use_swiglu:
            mlp["w_gate"] = dense("blocks.mlp.w_gate", (L, h, m), h)
        else:
            mlp["b_in"] = zeros("blocks.mlp.b_in", (L, m))
            mlp["b_out"] = zeros("blocks.mlp.b_out", (L, h))
        blocks["mlp"] = mlp

    params: Params = {
        "embed": {"tokens": normal("embed.tokens", (cfg.vocab_size, h),
                                   0.02)},
        "blocks": blocks,
        "final_norm": {"scale": ones("final_norm.scale", (h,))},
    }
    if not cfg.use_rope:
        params["embed"]["pos"] = normal("embed.pos", (cfg.max_seq_len, h),
                                        0.01)
    if not cfg.use_rmsnorm:
        params["final_norm"]["bias"] = zeros("final_norm.bias", (h,))
    if not cfg.tied_embeddings:
        params["lm_head"] = dense("lm_head", (h, cfg.vocab_size), h)
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
                 lead: Tuple[int, int], is_cuda: bool, dtype: torch.dtype,
                 with_mlp: bool = True) -> List[rm.Step]:
    """One transformer block on ``dtype`` activations as steps over named
    values: the input "x", the layer's params by path ("attn.wq", ...), the
    output "y" (and with MoE the layer's aux loss "moe_aux").  Values named
    as in the JAX package's checkpoint_name tags are kept by the policies
    that save those names.  Head counts come from the weights' last
    dimension (a tp shard's own).  ``with_mlp=False`` leaves out the steps
    from "mlp_in" to "mlp_out" (the mesh's MoE brings its own)."""
    b, s = lead
    hd = cfg.head_dim
    attn = lp["attn"]
    nh, nkv = attn["wq"].shape[-1] // hd, attn["wk"].shape[-1] // hd
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
        *(() if not with_mlp else _moe_steps(cfg) if cfg.num_experts > 1
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
                remat: Union[bool, str, None] = False, mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B, S] -> (final hidden states [B, S, H], aux dict).

    The trunk stops before the LM head so the loss can run the head
    blockwise (``chunked_cross_entropy``).  ``remat`` (``remat_policy``)
    says what each layer keeps for the backward; the backward recomputes
    the rest, the attention forward too when its residuals are not kept.
    With a ``mesh`` (a ``Mesh``, or its ``MeshLayout``), ``params`` holds
    ``Sharded`` leaves and ``tokens`` is a list of the tiles
    (``MeshLayout.rows`` order), each on its leader's device; the hidden
    states come back as such a list."""
    _, policy = remat_policy(remat)
    layout = _layout(mesh)
    if layout is None:
        x = embed_tokens(params, tokens, cfg, compute_dtype)
        positions = torch.arange(tokens.shape[1], device=x.device)
        layers = unbind_layers(params["blocks"], cfg.num_layers)
        block = functools.partial(block_forward, cfg=cfg,
                                  positions=positions, policy=policy)
    else:
        x, positions, layers = layout.embed(params, tokens, cfg,
                                            compute_dtype)
        # each block leaf's spec without its layer dimension
        specs = {path: leaf.sharding.spec[1:] for path, leaf in
                 _flat(params["blocks"]).items()}
        block = functools.partial(_mesh_block, specs=specs, cfg=cfg,
                                  positions=positions, policy=policy,
                                  layout=layout)
    aux = []
    for lp in layers:
        x, a = block(x, lp)
        aux.append(a)
    if layout is None:
        x = _norm(x, params["final_norm"], cfg)
    else:
        x = [_norm(x[i], _part(params["final_norm"], i), cfg)
             for i in layout.leaders]
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
                   loss_chunk: Optional[int] = 0, mesh=None):
    """batch: {"tokens": [B, S+1]} or {"tokens", "targets"}, optionally
    "loss_mask" [B, S].  Returns (loss, metrics).

    loss_chunk: sequence-chunk size for the blockwise LM head.  0 (default)
    chunks at 512 when the full logits tensor would be large
    (S*V > 2**25 elements); None disables; an int forces that chunk size.

    With a ``mesh`` (a ``Mesh``, or its ``MeshLayout``), ``params`` holds
    ``Sharded`` leaves and ``batch`` is a list of such dicts, one per tile
    of ``batch_spec()`` in batch order, each on its leader's device
    (``MeshLayout``); the loss and the metrics are the whole batch's, on
    the first device.
    """
    if mesh is not None:
        return _mesh_loss(params, batch, cfg, compute_dtype, moe_aux_weight,
                          remat, loss_chunk, _layout(mesh))
    tokens, targets = _split_targets(batch)
    s = tokens.shape[1]
    if loss_chunk == 0:
        loss_chunk = 512 if s * cfg.vocab_size > 2 ** 25 else None
    x, aux = apply_trunk(params, tokens, cfg, compute_dtype, remat=remat)
    nll = _nll(x, lm_head_weight(params, cfg, x.dtype), targets, loss_chunk)
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


def _split_targets(batch: Dict[str, torch.Tensor]):
    if "targets" in batch:
        return batch["tokens"], batch["targets"]
    return batch["tokens"][:, :-1], batch["tokens"][:, 1:]


def _nll(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
         loss_chunk: Optional[int]) -> torch.Tensor:
    """Per-token NLL [B, S] f32 of the head ``w`` [H, V] (x's dtype) on x."""
    if loss_chunk:
        return chunked_cross_entropy(x, w, targets,
                                     min(loss_chunk, x.shape[1]))
    logp = torch.log_softmax((x @ w).float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------
#
# One process runs every device's part of the step, as XLA's SPMD program
# runs on every device of the reference's mesh, and builds one autograd
# graph over all of them.  The batch's rows are cut over dp x fsdp and its
# sequence over sp (``sharding.batch_spec``): a *tile*, held by the ep x
# tp devices that share its dp, fsdp and sp indices.  The tile's first
# device, its *leader*, embeds its tokens and copies the embedding to the
# others (an ``all_gather`` of one part), and computes the final norm, the
# LM head and the loss on its tokens.  Under sp each device's RoPE
# positions are its shard's global ones and attention is one ring over
# each sp group (``ops/ring_attention.py``), a collective step of the
# remat layer.  Every device runs each layer on its own copy
# of the residual stream, with its tp shard's q/KV heads and MLP columns
# and its ep shard's experts: parameters cut over fsdp are all-gathered
# inside the layer (a remat policy that does not keep them gathers them
# again in the backward), and the partial outputs of ``wo`` and ``w_out``
# are summed over tp (``all_reduce``) before the output biases are added,
# once.  MoE
# routes once per layer over the whole batch in token order (each row's
# tokens over its sp shards; ``moe.route_rows``: the global capacity and
# positions), each ep shard computes its experts' buffer rows (a
# reduce-scatter over the tiles gives each device a slice of the global
# buffer and an all-gather returns the outputs), and
# the partial outputs are summed over ep x tp.  Each function in the graph
# is the whole model's, so a replicated parameter's gradient is the sum of
# its copies' gradients (``parallel/train_step.py`` sums them).

def _part(tree: Params, i: int) -> Params:
    """Device i's blocks of a tree of ``Sharded`` leaves."""
    return {k: _part(v, i) if isinstance(v, dict) else v.parts[i]
            for k, v in tree.items()}


class MeshLayout:
    """Which device holds which rows and who does what on a mesh.

    A *tile* is one block of the batch: its rows cut over dp x fsdp and,
    with ``sp > 1``, its sequence cut over sp.  The ep x tp devices that
    share a tile's dp, fsdp and sp indices hold it (``rows``, one group
    per tile in batch order: row block first, sp shard second); the
    group's first device is the tile's *leader*.  ``route_axes`` are the
    axes whose tiles MoE routes together (the mesh step routes the whole
    batch at once; the pipeline routes each dp and sp shard on its own).
    A mesh with ``pp > 1`` outside the pipeline holds a replica of
    everything on each pp index, as the reference's step does (the batch
    is not cut over pp): the work runs on pp index 0's devices (the mesh's
    first devices), and the other replicas' gradients are zero."""

    def __init__(self, mesh, route_axes: Tuple[str, ...] = ("dp", "fsdp",
                                                            "sp")):
        from ..parallel import mesh as pm
        self.mesh = mesh
        if pm.mesh_axis_size(mesh, "pp") > 1:
            mesh = pm.Mesh(mesh.devices[:1], mesh.axis_names)
        self.devices = mesh.device_list
        self.shape = mesh.shape
        self.sp = self.shape["sp"]
        #: the tiles' devices, in batch order; each leader first
        self.rows = pm.axis_groups(mesh, ("ep", "tp"))
        self.leaders = [g[0] for g in self.rows]
        #: per (ep, tp) index: the devices of the tiles that route together
        self.batch = pm.axis_groups(mesh, route_axes)
        lead = set(self.leaders)
        #: the leaders of the tiles that route together, in batch order
        self.route_groups = [g for g in self.batch if set(g) <= lead]
        self.route_sp = self.sp if "sp" in route_axes else 1
        self.tp = pm.axis_groups(mesh, ("tp",))
        self.fsdp = pm.axis_groups(mesh, ("fsdp",))
        self.sp_groups = pm.axis_groups(mesh, ("sp",))
        at = [mesh.coords(i) for i in range(len(self.devices))]
        self.ep_index = [c["ep"] for c in at]
        self.sp_index = [c["sp"] for c in at]

    def on(self, idx: Sequence[int]) -> List[torch.device]:
        return [self.devices[i] for i in idx]

    def gather_to(self, leaf, targets: Sequence[int]) -> Dict[int, torch.Tensor]:
        """A ``Sharded`` leaf whole on each device of ``targets``
        (differentiable: all-gathers, the last dimension first, each onto
        the devices the next one reads from)."""
        from ..parallel import mesh as pm
        mesh = leaf.sharding.mesh
        stages = [(d, pm.spec_axes(e)) for d, e in
                  enumerate(leaf.sharding.spec)
                  if math.prod(self.shape[a] for a in pm.spec_axes(e)) > 1]
        stages.reverse()
        needs, want = [], set(targets)
        for _, axes in reversed(stages):
            needs.append(want)
            want = {j for g in pm.axis_groups(mesh, axes) if want & set(g)
                    for j in g}
        needs.reverse()
        parts = list(leaf.parts)
        for (dim, axes), need in zip(stages, needs):
            new = [None] * len(parts)
            for g in pm.axis_groups(mesh, axes):
                to = [j for j in g if j in need]
                if to:
                    outs = pm.all_gather([parts[j] for j in g], dim,
                                         self.on(to))
                    for j, o in zip(to, outs):
                        new[j] = o
            parts = new
        return {t: parts[t] for t in targets}

    def embed_rows(self, params: Params, tokens: Sequence[torch.Tensor],
                   cfg: TransformerConfig, compute_dtype
                   ) -> List[torch.Tensor]:
        """Each leader embeds its tile and copies it to the tile's devices
        -> x per device.  Learned positions are the tile's global ones."""
        from ..parallel import mesh as pm
        emb = self.gather_to(params["embed"]["tokens"], self.leaders)
        pos = (self.gather_to(params["embed"]["pos"], self.leaders)
               if not cfg.use_rope else None)
        xs: List[Optional[torch.Tensor]] = [None] * len(self.devices)
        for g, lead, tok in zip(self.rows, self.leaders, tokens):
            x = emb[lead][tok.long()].to(compute_dtype)
            if pos is not None:
                s = tok.shape[1]
                p0 = self.sp_index[lead] * s
                x = x + pos[lead][p0:p0 + s][None].to(compute_dtype)
            for i, xi in zip(g, pm.all_gather([x], 0, self.on(g))):
                xs[i] = xi
        return xs

    def positions(self, s: int) -> List[torch.Tensor]:
        """Each device's global sequence positions for tiles of length s:
        its sp shard's, offset by ``sp_index * s``."""
        return [torch.arange(s, device=d) + self.sp_index[i] * s
                for i, d in enumerate(self.devices)]

    def layers(self, blocks: Params, num_layers: int
               ) -> List[List[Params]]:
        """Per layer, each device's slice of the stacked block params."""
        per_device = [unbind_layers(_part(blocks, i), num_layers)
                      for i in range(len(self.devices))]
        return [list(lps) for lps in zip(*per_device)]

    def embed(self, params: Params, tokens: Sequence[torch.Tensor],
              cfg: TransformerConfig, compute_dtype):
        """-> (x per device, positions per device, the layers' params
        per device)."""
        xs = self.embed_rows(params, tokens, cfg, compute_dtype)
        return (xs, self.positions(tokens[0].shape[1]),
                self.layers(params["blocks"], cfg.num_layers))


def _layout(mesh) -> Optional[MeshLayout]:
    """None, a mesh's layout, or the layout given."""
    if mesh is None or isinstance(mesh, MeshLayout):
        return mesh
    return MeshLayout(mesh)


def _collective(name: str, fn, bwd, ins, outs) -> rm.Step:
    return rm.Step(name, lambda *p: tuple(fn(p)), tuple(ins), tuple(outs),
                   rm.LINEAR, lambda *g: tuple(bwd(g)))


def _sum_steps(value: str, groups, layout: MeshLayout) -> List[rm.Step]:
    """``value`` summed over each group (``all_reduce``) into
    ``value + "+"``; nothing for groups of one."""
    from ..parallel import mesh as pm
    steps = []
    for g in groups:
        if len(g) == 1:
            continue
        devs = layout.on(g)
        steps.append(_collective(
            f"{value}_sum", lambda p, d=devs: pm.sum_parts(p, d),
            lambda gr, d=devs: pm.sum_parts(gr, d),
            [f"{value}@{j}" for j in g], [f"{value}+@{j}" for j in g]))
    return steps


def _rewire(steps: List[rm.Step], old: str, new: str) -> List[rm.Step]:
    return [st._replace(ins=tuple(new if n == old else n for n in st.ins))
            for st in steps]


def _mesh_block(xs, lps, specs: Dict[str, Any], cfg: TransformerConfig,
                positions, policy, layout: MeshLayout):
    """One block over every device of the mesh as one remat layer; ``specs``
    holds each block leaf's spec without its layer dimension."""
    from ..parallel import mesh as pm
    n = len(xs)
    moe = cfg.num_experts > 1
    values = {f"x@{i}": x for i, x in enumerate(xs)}
    flats = [_flat(lp) for lp in lps]
    steps: List[rm.Step] = []
    gathers: List[rm.Step] = []
    fsdp = layout.shape["fsdp"]
    leaders = set(layout.leaders)
    for path, spec in specs.items():
        dim = next((d for d, e in enumerate(spec)
                    if "fsdp" in pm.spec_axes(e)), None)
        cut = dim is not None and fsdp > 1
        for i in range(n):
            values[f"{path}#@{i}" if cut else f"{path}@{i}"] = flats[i][path]
        if not cut:
            continue
        for g in layout.fsdp:
            if path == "moe.router" and g[0] not in leaders:
                continue                  # only a row block's leader routes
            devs = layout.on(g)
            sizes = [flats[j][path].shape[dim] for j in g]
            gathers.append(_collective(
                "gather", lambda p, d=devs, k=dim: pm.gather_parts(p, k, d),
                lambda gr, d=devs, k=dim, z=sizes: pm.scatter_sum(gr, k, z, d),
                [f"{path}#@{j}" for j in g], [f"{path}@{j}" for j in g]))
    per = [rm.on_device(_layer_steps(lps[i], cfg, positions[i],
                                     xs[i].shape[:2], xs[i].is_cuda,
                                     xs[i].dtype, not moe), i)
           for i in range(n)]

    def cut_after(value):
        heads, tails = [], []
        for i, st in enumerate(per):
            k = next(j for j, x in enumerate(st) if f"{value}@{i}" in x.outs)
            heads.append(st[:k + 1])
            tails.append(st[k + 1:])
        return [x for h in heads for x in h], tails

    def summed(value, groups):
        nonlocal per
        head, per = cut_after(value)
        sums = _sum_steps(value, groups, layout)
        if sums:
            per = [_rewire(st, f"{value}@{i}", f"{value}+@{i}")
                   for i, st in enumerate(per)]
        return head + sums

    if layout.sp > 1:
        # every device's own attention step gives way to one ring over its
        # sp group
        head, per = cut_after("attn_v")
        assert all(st[0].name == "attention" for st in per)
        per = [st[1:] for st in per]
        steps += head + _ring_steps(cfg, layout, xs[0])
    steps += summed("attn_proj", layout.tp)
    if moe:
        head, per = cut_after("mlp_in")
        steps += head + _mesh_moe_steps(cfg, layout, [x.shape[:2] for x in xs])
    else:
        steps += summed("mlp_out" if cfg.use_swiglu else "mlp_proj",
                        layout.tp)
    steps += [x for st in per for x in st]
    steps = _gathers_first_used(gathers, steps)
    outs = tuple(f"y@{i}" for i in range(n))
    if moe:
        *ys, aux = rm.run(steps, values, outs + ("moe_aux",), policy)
        return ys, aux
    ys = rm.run(steps, values, outs, policy)
    return list(ys), torch.zeros((), dtype=torch.float32,
                                 device=layout.devices[0])


def _ring_steps(cfg: TransformerConfig, layout: MeshLayout,
                x: torch.Tensor) -> List[rm.Step]:
    """Attention over each sp group: "attn_q/k/v@j" -> "attn_out@j" for
    the group's devices j, by ring attention (``ops/ring_attention.py``).
    With the kernels its residuals are flash's (q, k, v, out, lse), named
    as flash's, so the policies that keep those names keep its graph;
    the recurrence's residuals are unnamed."""
    from ..ops.ring_attention import _ring_attn_shard, ring_kernel_takes
    cap = cfg.attn_logit_softcap
    kernel = ring_kernel_takes(x.is_cuda, cfg.head_dim, cap, x.dtype)

    def ring(*qkv):
        return tuple(_ring_attn_shard(qkv[0::3], qkv[1::3], qkv[2::3],
                                      causal=cfg.causal, logit_softcap=cap))
    return [rm.Step("attention", ring,
                    tuple(f"{v}@{j}" for j in g
                          for v in ("attn_q", "attn_k", "attn_v")),
                    tuple(f"attn_out@{j}" for j in g),
                    residual_names=FLASH_RESIDUALS if kernel else None)
            for g in layout.sp_groups]


def _gathers_first_used(gathers: List[rm.Step], steps: List[rm.Step]
                        ) -> List[rm.Step]:
    """Each gather step placed just before the first step that reads what
    it gathers, so the backward reduce-scatters a gathered weight's
    gradient soon after its last use."""
    first = {}
    for k, st in enumerate(steps):
        for n in st.ins:
            first.setdefault(n, k)
    at: Dict[int, List[rm.Step]] = {}
    for g in gathers:
        at.setdefault(min(first.get(n, len(steps)) for n in g.outs),
                      []).append(g)
    out = []
    for k, st in enumerate(steps):
        out += at.get(k, []) + [st]
    return out + at.get(len(steps), [])


def _mesh_moe_steps(cfg: TransformerConfig, layout: MeshLayout,
                    leads) -> List[rm.Step]:
    """The sparse MLP over the mesh: "mlp_in@i" -> "mlp_out@i" on every
    device, and the layer's aux loss "moe_aux".  Every step's residuals
    are unnamed, so every remat policy replays them, as the one-device
    ``moe`` step."""
    from ..parallel import mesh as pm
    n = len(layout.devices)
    e, k = cfg.num_experts, cfg.experts_per_token
    ep = layout.shape["ep"]
    e_loc = e // ep
    blocks = len(layout.batch[0])
    sp_r = layout.route_sp
    group0 = layout.route_groups[0]
    s_loc = leads[group0[0]][1]
    cap = moe_ops.capacity(cfg.expert_capacity_factor, k,
                           sum(leads[j][0] for j in group0) // sp_r,
                           s_loc * sp_r, e)
    c_pad = -(-cap // blocks) * blocks        # the buffer cut over tiles
    steps = [rm.Step("router", rm.dot, (f"mlp_in@{j}", f"moe.router@{j}"),
                     (f"router_logits@{j}",), rm.DOT)
             for j in layout.leaders]
    tile = {lead: g for lead, g in zip(layout.leaders, layout.rows)}

    def route(*logits, leaders):
        # one batch in token order: each row's tokens over its sp shards
        n_rows = len(leaders) // sp_r
        dev = logits[0].device
        per_row = [torch.cat([logits[r * sp_r + si].to(dev)
                              for si in range(sp_r)], 1)
                   for r in range(n_rows)]
        r = moe_ops.route_rows(per_row, k, cap)
        got = []
        t0 = 0
        for ri, row in enumerate(per_row):
            rb, srow = row.shape[:2]
            fields = [f[t0:t0 + rb * srow].view(rb, srow, -1) for f in r[:4]]
            t0 += rb * srow
            for si in range(sp_r):
                cols = slice(si * s_loc, (si + 1) * s_loc)
                rg = moe_ops.Routing(*(f[:, cols].reshape(-1, f.shape[-1])
                                       for f in fields), r.aux)
                g = tile[leaders[ri * sp_r + si]]
                for i, w in zip(g, pm.all_gather([rg.weight], 0,
                                                 layout.on(g))):
                    dest, src, here = moe_ops.local_slots(
                        rg, cap, layout.ep_index[i] * e_loc, e_loc, c_pad)
                    d = layout.devices[i]
                    got += [dest.to(d), src.to(d), w * here.to(d)]
        return (*got, r.aux)

    groups = layout.route_groups
    for gi, leaders in enumerate(groups):
        aux = "moe_aux" if len(groups) == 1 else f"moe_aux#{gi}"
        steps.append(rm.Step(
            "moe_route", functools.partial(route, leaders=leaders),
            tuple(f"router_logits@{j}" for j in leaders),
            tuple(f"moe_{v}@{i}" for j in leaders for i in tile[j]
                  for v in ("dest", "src", "wt")) + (aux,)))
    if len(groups) > 1:
        # the routes' aux losses averaged, in order on the first device
        def mean(*a):
            return pm.ordered_sum([x.to(a[0].device) for x in a]) / len(a)
        steps.append(rm.Step("moe_aux_mean", mean,
                             tuple(f"moe_aux#{gi}" for gi in
                                   range(len(groups))), ("moe_aux",)))
    xs, xs_part, ys_part, ys = "moe_xs", "moe_xs_part", "moe_ys_part", "moe_ys"
    if blocks == 1:
        xs_part, ys_part = xs, ys
    out = "mlp_out" if all(len(g) == 1 for g in layout.rows) else "mlp_part"
    for i in range(n):
        steps.append(rm.Step(
            "moe_dispatch",
            lambda x, dest: moe_ops.dispatch(x, dest, e_loc, c_pad),
            (f"mlp_in@{i}", f"moe_dest@{i}"), (f"{xs}@{i}",)))
    if blocks > 1:
        for g in layout.batch:
            devs = layout.on(g)
            sizes = [c_pad // blocks] * blocks
            steps.append(_collective(
                "moe_scatter",
                lambda p, d=devs, z=sizes: pm.scatter_sum(p, 1, z, d),
                lambda gr, d=devs: pm.gather_parts(gr, 1, d),
                [f"{xs}@{j}" for j in g], [f"{xs_part}@{j}" for j in g]))
    for i in range(n):
        steps.append(rm.Step(
            "moe_experts", moe_ops.experts,
            (f"{xs_part}@{i}", f"moe.w_gate@{i}", f"moe.w_in@{i}",
             f"moe.w_out@{i}"), (f"{ys_part}@{i}",)))
    if blocks > 1:
        for g in layout.batch:
            devs = layout.on(g)
            sizes = [c_pad // blocks] * blocks
            steps.append(_collective(
                "moe_gather", lambda p, d=devs: pm.gather_parts(p, 1, d),
                lambda gr, d=devs, z=sizes: pm.scatter_sum(gr, 1, z, d),
                [f"{ys_part}@{j}" for j in g], [f"{ys}@{j}" for j in g]))
    for i in range(n):
        steps.append(rm.Step(
            "moe_combine",
            lambda y, src, wt, lead=tuple(leads[i]): moe_ops.combine(
                y, src, wt, lead),
            (f"{ys}@{i}", f"moe_src@{i}", f"moe_wt@{i}"), (f"{out}@{i}",)))
    if out != "mlp_out":
        for g in layout.rows:
            devs = layout.on(g)
            steps.append(_collective(
                "moe_sum", lambda p, d=devs: pm.sum_parts(p, d),
                lambda gr, d=devs: pm.sum_parts(gr, d),
                [f"{out}@{j}" for j in g], [f"mlp_out@{j}" for j in g]))
    return steps


def _mesh_loss(params: Params, batch: Sequence[Dict[str, torch.Tensor]],
               cfg: TransformerConfig, compute_dtype, moe_aux_weight: float,
               remat, loss_chunk: Optional[int], layout: MeshLayout):
    """``causal_lm_loss`` over a mesh: each leader's NLL summed over its
    tile, the tiles' sums added in batch order on the first device and
    divided by the whole batch's token count (or ``loss_mask`` sum)."""
    from ..parallel import mesh as pm
    if len(batch) != len(layout.rows):
        raise ValueError(f"{len(batch)} tiles for a mesh of "
                         f"{len(layout.rows)} (dp x fsdp x sp)")
    split = [_split_targets(b) for b in batch]
    s = split[0][0].shape[1]
    if loss_chunk == 0:
        loss_chunk = 512 if s * cfg.vocab_size > 2 ** 25 else None
    xs, aux = apply_trunk(params, [t for t, _ in split], cfg, compute_dtype,
                          remat=remat, mesh=layout)
    head = (params["embed"]["tokens"] if cfg.tied_embeddings
            else params["lm_head"])
    heads = layout.gather_to(head, layout.leaders)
    dev = layout.devices[0]
    sums, counts = [], []
    for lead, x, (_, targets), b in zip(layout.leaders, xs, split, batch):
        w = heads[lead].T if cfg.tied_embeddings else heads[lead]
        nll = _nll(x, w.to(x.dtype), targets, loss_chunk)
        mask = b.get("loss_mask")
        if mask is not None:
            nll = nll * mask
            counts.append(mask.sum().to(dev))
        sums.append(nll.sum().to(dev))
    total_nll = pm.ordered_sum(sums)
    if counts:
        denom = pm.ordered_sum(counts)
        loss = total_nll / torch.clamp_min(denom, 1)
    else:
        denom = torch.full((), sum(t.numel() for t, _ in split),
                           dtype=torch.int32, device=dev)
        loss = total_nll / denom
    total = loss + moe_aux_weight * aux["moe_aux_loss"]
    return total, {"loss": loss, "moe_aux_loss": aux["moe_aux_loss"],
                   "tokens": denom}
