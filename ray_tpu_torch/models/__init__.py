"""ray_tpu_torch.models — the transformer, its decode path and the presets."""

from .config import (PRESETS, TransformerConfig, gpt2_small, llama3_8b,
                     llama3_70b, llama_1b, mixtral_8x7b, tiny)
from .convert import params_from_numpy, train_state_from_numpy
from .transformer import apply, causal_lm_loss, init_params

__all__ = ["TransformerConfig", "PRESETS", "gpt2_small", "llama3_8b",
           "llama3_70b", "llama_1b", "mixtral_8x7b", "tiny", "init_params",
           "apply", "causal_lm_loss", "params_from_numpy",
           "train_state_from_numpy"]
