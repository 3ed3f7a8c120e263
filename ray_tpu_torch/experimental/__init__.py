from ray_tpu_torch.experimental import internal_kv  # noqa: F401
