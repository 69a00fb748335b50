"""ray_tpu_torch.models — the transformer, its decode path and the presets."""

from .config import (PRESETS, TransformerConfig, gpt2_small, llama3_8b,
                     llama3_70b, llama_1b, mixtral_8x7b, tiny)
from .convert import params_from_numpy
from .transformer import apply, init_params

__all__ = ["TransformerConfig", "PRESETS", "gpt2_small", "llama3_8b",
           "llama3_70b", "llama_1b", "mixtral_8x7b", "tiny", "init_params",
           "apply", "params_from_numpy"]
