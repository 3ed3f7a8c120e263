"""Attention ops of the port: each module holds one hand-written CUDA
kernel (source under ``ray_tpu_torch/csrc/``), its plain PyTorch
version, and a count of its launches."""
