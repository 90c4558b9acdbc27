"""Small JAX helpers (reference `mava/utils/jax_utils.py`)."""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp


def merge_leading_dims(x: jnp.ndarray, num_dims: int) -> jnp.ndarray:
    """Merge the first `num_dims` dimensions into one."""
    return jnp.reshape(x, (-1, *x.shape[num_dims:]))


def unreplicate_n_dims(x: Any, unreplicate_depth: int = 2) -> Any:
    """Take index [0, 0, ...] along the first `unreplicate_depth` axes of every leaf."""
    return jax.tree.map(lambda y: y[(0,) * unreplicate_depth], x)


def unreplicate_batch_dim(x: Any) -> Any:
    """Strip a leading (replicated) batch axis from every leaf."""
    return jax.tree.map(lambda y: y[0], x)


def switch_leading_axes(x: Any) -> Any:
    """Swap the first two axes of every leaf ((B, T, ...) <-> (T, B, ...))."""
    return jax.tree.map(lambda y: jnp.swapaxes(y, 0, 1), x)


def pack_pytree_rows(tree: Any, num_rows: int):
    """Pack every leaf of `tree` into ONE (num_rows, W) int32 buffer, bit-exactly.

    Permuting a transition pytree leaf-by-leaf issues one skinny gather per leaf,
    many of them (N,)-shaped. Packing the whole minibatch payload into a single
    wide matrix makes the epoch shuffle one contiguous-row gather (hypothesis to
    A/B on the GPU: fewer, wider gathers are cheaper, ROADMAP S5).

    float32/int32/uint32 leaves are bitcast (exact); bool leaves are widened to
    int32 (exact). The int32 carrier avoids any float canonicalisation concerns
    for NaN bit patterns. Returns `(packed, unpack)` where `unpack(rows)` maps any
    (m, W) row slice back to the tree structure with leading dim m.
    """
    leaves, treedef = jax.tree.flatten(tree)
    flats = []
    widths = []
    for leaf in leaves:
        if leaf.ndim == 0 or leaf.shape[0] != num_rows:
            raise ValueError(
                f"pack_pytree_rows: leaf has shape {leaf.shape}, expected leading "
                f"dim {num_rows}"
            )
        f = jnp.reshape(leaf, (num_rows, -1))
        if f.dtype == jnp.bool_:
            f = f.astype(jnp.int32)
        elif f.dtype.itemsize == 4:
            f = jax.lax.bitcast_convert_type(f, jnp.int32)
        else:
            raise TypeError(
                f"pack_pytree_rows: unsupported dtype {f.dtype} "
                "(only 4-byte dtypes and bool)"
            )
        flats.append(f)
        widths.append(f.shape[1])
    packed = flats[0] if len(flats) == 1 else jnp.concatenate(flats, axis=1)

    def unpack(rows: jnp.ndarray) -> Any:
        m = rows.shape[0]
        out = []
        offset = 0
        for leaf, width in zip(leaves, widths):
            sl = rows[:, offset : offset + width]
            if leaf.dtype == jnp.bool_:
                sl = sl.astype(jnp.bool_)
            elif leaf.dtype != jnp.int32:
                sl = jax.lax.bitcast_convert_type(sl, leaf.dtype)
            out.append(jnp.reshape(sl, (m, *leaf.shape[1:])))
            offset += width
        return jax.tree.unflatten(treedef, out)

    return packed, unpack


def select_along_last(values: jnp.ndarray, index: jnp.ndarray) -> jnp.ndarray:
    """values[..., index] for a small last axis, as a one-hot multiply-sum.

    `take_along_axis` on the minor axis lowers to a per-element gather; for small
    trailing axes (actions, q-heads) the one-hot select fuses elementwise instead
    (hypothesis to A/B on the GPU, ROADMAP S5). Out-of-range indices clamp like
    gather would, rather than silently contributing 0."""
    index = jnp.clip(index, 0, values.shape[-1] - 1)
    onehot = index[..., None] == jnp.arange(values.shape[-1])
    return jnp.sum(jnp.where(onehot, values, 0), axis=-1)
