from mava_jax.replay.item_buffer import make_item_buffer
from mava_jax.replay.trajectory_buffer import make_trajectory_buffer
from mava_jax.replay.vault import Vault

__all__ = ["make_item_buffer", "make_trajectory_buffer", "Vault"]
