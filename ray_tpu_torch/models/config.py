"""Model configs: one TransformerConfig covers the GPT-2, Llama-3 and Mixtral
families.

Counterpart of ``ray_tpu/models/config.py``, kept as its own copy so the port
imports nothing of the JAX package.  Fields, properties and presets are the
same; the per-device peak table has the JAX package's shape, keyed on the
card's name in place of the TPU's device kind.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Per-card peak bf16 matmul FLOP/s by device name — the denominator of the
#: train observability plane's running MFU.  The H100 SXM's dense bf16
#: tensor-core rate (NVIDIA's data sheet).
PEAK_BF16_FLOPS = {
    "h100": 989e12,
    "cpu": 1e12,         # nominal, for CI runs only
}


def detect_peak_flops(device) -> float:
    """Peak bf16 FLOP/s of one device, keyed on
    ``torch.cuda.get_device_name`` (falls back to the nominal CPU figure
    for CI runs)."""
    import torch
    device = torch.device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu").lower()
    for key, val in PEAK_BF16_FLOPS.items():
        if key in kind:
            return val
    return PEAK_BF16_FLOPS["cpu"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    num_layers: int
    hidden_size: int
    num_heads: int
    num_kv_heads: int           # < num_heads => GQA (Llama-3/Mixtral)
    mlp_size: int
    max_seq_len: int
    # architecture flags
    use_rope: bool = True       # False => learned positional embeddings (GPT-2)
    rope_theta: float = 500_000.0
    use_rmsnorm: bool = True    # False => LayerNorm with bias (GPT-2)
    use_qkv_bias: bool = False  # True => biases on Q/K/V only (Qwen-2)
    use_swiglu: bool = True     # False => GELU MLP (GPT-2)
    tied_embeddings: bool = False
    # MoE (Mixtral): num_experts > 1 enables the sparse MLP
    num_experts: int = 1
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    # numerics
    norm_eps: float = 1e-5
    # attention
    causal: bool = True
    attn_logit_softcap: float = 0.0
    #: "auto" (mha dispatcher: the flash kernel for bf16 CUDA tensors at
    #: long sequences, plain elsewhere), "plain", "flash"
    #: (ops/flash_attention), or "splash" (ops/splash_attention: kernel B4
    #: on bf16 CUDA tensors; a shape, dtype or head dim it does not take
    #: falls back to "auto" after one RuntimeWarning).
    attention_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        """Approximate parameter count (for MFU math)."""
        h, v, L = self.hidden_size, self.vocab_size, self.num_layers
        attn = h * h + 2 * h * (self.num_kv_heads * self.head_dim) + h * h
        if self.num_experts > 1:
            mlp = self.num_experts * 3 * h * self.mlp_size + h * self.num_experts
        else:
            mlp = (3 if self.use_swiglu else 2) * h * self.mlp_size
        emb = v * h * (1 if self.tied_embeddings else 2)
        return L * (attn + mlp) + emb

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Training FLOPs/token ≈ 6*N_active + attention quadratic term."""
        h, L = self.hidden_size, self.num_layers
        attn = L * (h * h + 2 * h * self.num_kv_heads * self.head_dim + h * h)
        if self.num_experts > 1:
            mlp = L * self.experts_per_token * 3 * h * self.mlp_size
        else:
            mlp = L * (3 if self.use_swiglu else 2) * h * self.mlp_size
        emb = self.vocab_size * h
        n_active = attn + mlp + emb
        s = seq_len or self.max_seq_len
        attn_quad = L * 2 * s * h  # 2*s*h per token for QK^T + AV (causal halves it)
        return 6.0 * n_active + 6.0 * attn_quad


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def gpt2_small(max_seq_len: int = 1024) -> TransformerConfig:
    """GPT-2 124M. Vocab padded to a multiple of 128."""
    return TransformerConfig(
        vocab_size=50304, num_layers=12, hidden_size=768, num_heads=12,
        num_kv_heads=12, mlp_size=3072, max_seq_len=max_seq_len,
        use_rope=False, use_rmsnorm=False, use_swiglu=False,
        tied_embeddings=True, norm_eps=1e-5)


def llama3_8b(max_seq_len: int = 8192) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=128256, num_layers=32, hidden_size=4096, num_heads=32,
        num_kv_heads=8, mlp_size=14336, max_seq_len=max_seq_len,
        rope_theta=500_000.0)


def llama3_70b(max_seq_len: int = 8192) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=128256, num_layers=80, hidden_size=8192, num_heads=64,
        num_kv_heads=8, mlp_size=28672, max_seq_len=max_seq_len,
        rope_theta=500_000.0)


def llama_1b(max_seq_len: int = 2048) -> TransformerConfig:
    """~1.2B Llama-style model."""
    return TransformerConfig(
        vocab_size=32768, num_layers=16, hidden_size=2048, num_heads=16,
        num_kv_heads=8, mlp_size=5632, max_seq_len=max_seq_len)


def llama_400m(max_seq_len: int = 2048) -> TransformerConfig:
    """~0.4B Llama-style model."""
    return TransformerConfig(
        vocab_size=32768, num_layers=12, hidden_size=1536, num_heads=12,
        num_kv_heads=6, mlp_size=4096, max_seq_len=max_seq_len)


def mixtral_8x7b(max_seq_len: int = 8192) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32000, num_layers=32, hidden_size=4096, num_heads=32,
        num_kv_heads=8, mlp_size=14336, max_seq_len=max_seq_len,
        rope_theta=1_000_000.0, num_experts=8, experts_per_token=2)


def gemma2_2b(max_seq_len: int = 8192) -> TransformerConfig:
    """Gemma-2-2B-class: GQA, attention logit softcapping, tied embeddings."""
    return TransformerConfig(
        vocab_size=256128, num_layers=26, hidden_size=2304, num_heads=8,
        num_kv_heads=4, mlp_size=9216, max_seq_len=max_seq_len,
        rope_theta=10_000.0, attn_logit_softcap=50.0, tied_embeddings=True)


def qwen2_7b(max_seq_len: int = 8192) -> TransformerConfig:
    """Qwen-2-7B-class: Llama-like with QKV biases (use_qkv_bias marker)."""
    return TransformerConfig(
        vocab_size=152064, num_layers=28, hidden_size=3584, num_heads=28,
        num_kv_heads=4, mlp_size=18944, max_seq_len=max_seq_len,
        rope_theta=1_000_000.0, use_qkv_bias=True)


def tiny(vocab: int = 256, layers: int = 2, hidden: int = 64, heads: int = 4,
         seq: int = 64, experts: int = 1) -> TransformerConfig:
    """Test-size config."""
    return TransformerConfig(
        vocab_size=vocab, num_layers=layers, hidden_size=hidden, num_heads=heads,
        num_kv_heads=max(1, heads // 2), mlp_size=hidden * 3, max_seq_len=seq,
        num_experts=experts, experts_per_token=min(2, experts))


PRESETS = {
    "gpt2-124m": gpt2_small,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama-1b": llama_1b,
    "llama-400m": llama_400m,
    "mixtral-8x7b": mixtral_8x7b,
    "gemma2-2b": gemma2_2b,
    "qwen2-7b": qwen2_7b,
    "tiny": tiny,
}
