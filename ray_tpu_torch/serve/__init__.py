"""ray_tpu_torch.serve — the continuous-batching LLM engine."""

from .llm import GenRequest, LLMEngine

__all__ = ["GenRequest", "LLMEngine"]
