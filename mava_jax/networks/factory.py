"""Build torsos/heads from config dicts.

Replaces the reference's `hydra.utils.instantiate(_target_=...)` pattern
(`mava/systems/ppo/ff_ippo.py:363-367`) with an explicit registry — hydra is not a
dependency of this framework.
"""

from __future__ import annotations

from typing import Any, Dict

from mava_jax.networks.heads import ContinuousActionHead, DiscreteActionHead
from mava_jax.networks.torsos import CNNTorso, MLPTorso

_TORSOS = {"MLPTorso": MLPTorso, "CNNTorso": CNNTorso}
_HEADS = {
    "DiscreteActionHead": DiscreteActionHead,
    "ContinuousActionHead": ContinuousActionHead,
}


def make_torso(cfg: Dict[str, Any]):
    """cfg e.g. {"type": "MLPTorso", "layer_sizes": [128, 128], "activation": "relu"}."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return _TORSOS[kind](**cfg)


def make_action_head(cfg: Dict[str, Any], action_dim: int):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return _HEADS[kind](action_dim=action_dim, **cfg)


def make_rollout_noise_fn(cfg: Dict[str, Any]):
    """Pre-scan sampling-noise generator matching the head's `sample_from_noise`.

    Rollout scans hoist ALL their RNG into one batched pre-scan draw: Gumbel noise
    for discrete heads (Gumbel-max sampling), standard-normal noise for continuous
    tanh-Normal heads. `fn(key, shape)` -> noise array. Explicit dispatch so a new
    head type fails loudly here until its noise distribution is registered."""
    import jax

    noise_fns = {
        "DiscreteActionHead": jax.random.gumbel,
        "ContinuousActionHead": jax.random.normal,
    }
    if cfg["type"] not in noise_fns:
        raise KeyError(
            f"make_rollout_noise_fn: no sampling-noise distribution registered for "
            f"action head {cfg['type']!r}"
        )
    return noise_fns[cfg["type"]]


def make_log_prob_from_params(cfg: Dict[str, Any]):
    """Companion to `raw_params`: `fn(raw_params, action) -> log_prob`.

    Lets rollout scans store the (already computed) distribution parameters and
    defer log_prob to ONE batched post-rollout computation."""
    from mava_jax.distributions import Categorical, TanhNormal

    log_prob_fns = {
        "DiscreteActionHead": lambda p, a: Categorical(p).log_prob(a),
        "ContinuousActionHead": lambda p, a: TanhNormal(p[0], p[1]).log_prob(a),
    }
    if cfg["type"] not in log_prob_fns:
        raise KeyError(
            f"make_log_prob_from_params: no log-prob reconstruction registered for "
            f"action head {cfg['type']!r}"
        )
    return log_prob_fns[cfg["type"]]
