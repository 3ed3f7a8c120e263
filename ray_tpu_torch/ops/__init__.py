"""Attention ops of the port.  ``flash_attention`` and
``paged_attention`` each hold one hand-written CUDA kernel (source under
``ray_tpu_torch/csrc/``), its plain PyTorch version, and a count of its
launches; ``ring_attention`` is sequence-parallel attention over a
process group in plain PyTorch, as the JAX package's is no kernel
either."""
