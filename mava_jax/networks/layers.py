"""A minimal pure-JAX module system and the layers the networks are built from.

A network is a frozen dataclass whose `__call__(scope, *inputs)` reads its
parameters through `scope`. `init(key, *inputs)` runs that call once, creating
each parameter where it is first asked for, and returns `{"params": tree}`;
`apply(variables, *inputs, method=...)` runs a method on existing parameters.

Parameter names follow flax.linen's (`Dense_0/kernel`, a submodule held as a
field is named after the field), and each parameter's init key is derived the
way flax derives it: the SHA-1 of the scope path plus a per-scope counter,
folded into the root key. Parameter trees and initial values are therefore
interchangeable with those of the flax modules this replaces
(tests/test_networks.py pins both).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

Initializer = Callable[..., jax.Array]

orthogonal = jax.nn.initializers.orthogonal
lecun_normal = jax.nn.initializers.lecun_normal
zeros = jax.nn.initializers.zeros


def _fold_path(key: jax.Array, path: Tuple[Any, ...]) -> jax.Array:
    digest = hashlib.sha1()
    for part in path:
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        else:
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(digest.digest()[:4], "big"))
    )


class Scope:
    """One module's view of the parameter tree. With a `key` it creates the
    parameters it is asked for (init); without one it only reads them (apply)."""

    def __init__(
        self,
        params: Dict[str, Any],
        key: Optional[jax.Array] = None,
        path: Tuple[str, ...] = (),
    ):
        self.params = params
        self._key = key
        self._path = path
        self._count = 0

    def param(self, name: str, init_fn: Initializer, shape: Tuple[int, ...]) -> jax.Array:
        """The float32 parameter `name`, created with `init_fn(key, shape)` at init."""
        if name not in self.params:
            if self._key is None:
                raise KeyError(f"missing parameter {'/'.join(self._path + (name,))}")
            self._count += 1
            key = _fold_path(self._key, self._path + (self._count,))
            self.params[name] = init_fn(key, shape, jnp.float32)
        return self.params[name]

    def child(self, name: str) -> "Scope":
        if self._key is None:
            return Scope(self.params[name], None, self._path + (name,))
        return Scope(self.params.setdefault(name, {}), self._key, self._path + (name,))


class Module:
    """Base class: subclasses are frozen dataclasses defining `__call__(scope, ...)`."""

    def init(self, key: jax.Array, *inputs, method: str = "__call__") -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        getattr(self, method)(Scope(params, key), *inputs)
        return {"params": params}

    def apply(self, variables: Dict[str, Any], *inputs, method: str = "__call__"):
        return getattr(self, method)(Scope(variables["params"]), *inputs)


module = dataclasses.dataclass(frozen=True)


def dense(scope: Scope, x: jax.Array, features: int, kernel_init: Initializer):
    """`x @ kernel + bias` over the last axis (flax `nn.Dense`)."""
    kernel = scope.param("kernel", kernel_init, (x.shape[-1], features))
    bias = scope.param("bias", zeros, (features,))
    dtype = jnp.result_type(x, kernel, bias)
    x, kernel, bias = x.astype(dtype), kernel.astype(dtype), bias.astype(dtype)
    y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias


def layer_norm(scope: Scope, x: jax.Array, dtype=None, epsilon: float = 1e-6):
    """Scale-free LayerNorm over the last axis (flax `nn.LayerNorm(use_scale=False)`):
    statistics in at least float32, output in `dtype` (default: the input's)."""
    bias = scope.param("bias", zeros, (x.shape[-1],))
    stats = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = stats.mean(-1, keepdims=True)
    var = jnp.maximum(0.0, lax.square(stats).mean(-1, keepdims=True) - lax.square(mean))
    y = (x - mean) * lax.rsqrt(var + epsilon) + bias
    return y.astype(dtype or jnp.result_type(x, bias))


def conv2d(
    scope: Scope, x: jax.Array, features: int, kernel: int, stride: int, dtype
):
    """SAME-padded NHWC convolution with bias (flax `nn.Conv`); any number of
    leading batch axes are folded into one for the convolution."""
    batch_shape = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:])
    w = scope.param("kernel", lecun_normal(), (kernel, kernel, x.shape[-1], features))
    bias = scope.param("bias", zeros, (features,))
    y = lax.conv_general_dilated(
        x.astype(dtype),
        w.astype(dtype),
        (stride, stride),
        "SAME",
        lhs_dilation=(1, 1),
        rhs_dilation=(1, 1),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y = y + bias.astype(dtype)
    return y.reshape(batch_shape + y.shape[1:])
