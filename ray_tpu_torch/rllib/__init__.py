from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
