from mava_jax.ops.gae import calculate_gae
from mava_jax.ops.losses import clipped_ppo_policy_loss, clipped_value_loss

__all__ = ["calculate_gae", "clipped_ppo_policy_loss", "clipped_value_loss"]
