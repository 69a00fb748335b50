"""ray_tpu_torch.train — checkpoint IO (the trainer and its runtime wait for
ROADMAP A4)."""

from .torch_utils import load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree"]
