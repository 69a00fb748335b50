"""ray_tpu_torch.ops — attention and the hand-written CUDA kernels."""
