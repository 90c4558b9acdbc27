"""Network torsos (feature extractors).

Capability parity with reference `mava/networks.py:39-85` (MLPTorso, CNNTorso):
orthogonal(sqrt(2)) kernels, optional scale-free LayerNorm, relu/tanh activations.
Init scales are kept identical to the reference since they matter for curve matching
(SURVEY.md hard part #3).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.networks.layers import (
    Module,
    Scope,
    conv2d,
    dense,
    layer_norm,
    module,
    orthogonal,
)


def parse_activation_fn(name: str):
    return {"relu": jax.nn.relu, "tanh": jnp.tanh}[name]


@module
class MLPTorso(Module):
    """A stack of Dense layers over the last axis; leading dims are batch."""

    layer_sizes: Sequence[int]
    activation: str = "relu"
    use_layer_norm: bool = False

    def __call__(self, scope: Scope, x: jnp.ndarray) -> jnp.ndarray:
        act = parse_activation_fn(self.activation)
        for i, size in enumerate(self.layer_sizes):
            x = dense(scope.child(f"Dense_{i}"), x, size, orthogonal(np.sqrt(2)))
            if self.use_layer_norm:
                x = layer_norm(scope.child(f"LayerNorm_{i}"), x)
            x = act(x)
        return x


@module
class CNNTorso(Module):
    """A stack of Conv layers; collapses (H, W, C) into one feature axis at the end,
    keeping any batch/agent/time leading dims (reference `networks.py:61-85`).

    `compute_dtype: bfloat16` runs the convolutions in bf16 (params and outputs
    stay float32). Opt-in via the network config; the default float32 matches
    the reference numerics.
    """

    channel_sizes: Sequence[int]
    kernel_sizes: Sequence[int]
    strides: Sequence[int]
    activation: str = "relu"
    use_layer_norm: bool = False
    compute_dtype: str = "float32"

    def __call__(self, scope: Scope, x: jnp.ndarray) -> jnp.ndarray:
        act = parse_activation_fn(self.activation)
        dtype = jnp.dtype(self.compute_dtype)
        x = x.astype(dtype)
        for i, (channel, kernel, stride) in enumerate(
            zip(self.channel_sizes, self.kernel_sizes, self.strides)
        ):
            x = conv2d(scope.child(f"Conv_{i}"), x, channel, kernel, stride, dtype)
            if self.use_layer_norm:
                x = layer_norm(scope.child(f"LayerNorm_{i}"), x, dtype=dtype)
            x = act(x)
        # Merge the trailing (H, W, C) dims into a single feature axis.
        return jax.lax.collapse(x.astype(jnp.float32), x.ndim - 3)
