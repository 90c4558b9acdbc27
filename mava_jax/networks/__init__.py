"""Network zoo."""

from mava_jax.networks.actor_critic import (
    FeedForwardActor,
    FeedForwardQNet,
    FeedForwardValueNet,
    RecQNetwork,
    RecurrentActor,
    RecurrentValueNet,
    ScannedRNN,
)
from mava_jax.networks.factory import make_torso
from mava_jax.networks.heads import ContinuousActionHead, DiscreteActionHead
from mava_jax.networks.torsos import CNNTorso, MLPTorso

__all__ = [
    "CNNTorso",
    "ContinuousActionHead",
    "DiscreteActionHead",
    "FeedForwardActor",
    "FeedForwardQNet",
    "FeedForwardValueNet",
    "MLPTorso",
    "RecQNetwork",
    "RecurrentActor",
    "RecurrentValueNet",
    "ScannedRNN",
    "make_torso",
]
