"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute plane.

A package of its own beside ``ray_tpu``: it imports ``torch`` and never
``jax`` or anything of ``ray_tpu``.  Module paths mirror ``ray_tpu/<path>``.
Entry points run on the card unless the caller passes ``device="cpu"``.
Kernels are CUDA C++ for Hopper (``csrc/``), built with nvcc at first use.
"""
