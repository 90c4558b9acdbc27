"""Flat item replay buffer: a ring of independent transitions with uniform sampling.

Replaces flashbax's `make_item_buffer` (used by the SAC systems, reference
`mava/systems/sac/ff_isac.py:171-177`). Items added in batches of `add_batch_size`
(one per env per step); sampling is uniform over the valid prefix. Pure functions,
static shapes, lives on-device inside the compiled step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from mava_jax.utils import struct


@struct.dataclass
class ItemBufferState:
    experience: Any  # pytree, leaves (max_length, ...)
    current_index: jnp.ndarray  # () int32
    is_full: jnp.ndarray  # () bool


class SampleBatch(NamedTuple):
    experience: Any


class ItemBuffer(NamedTuple):
    init: Any
    add: Any
    sample: Any
    can_sample: Any


def make_item_buffer(
    max_length: int,
    min_length: int,
    sample_batch_size: int,
    add_batch_size: int,
) -> ItemBuffer:
    def init(dummy_item: Any) -> ItemBufferState:
        experience = jax.tree.map(
            lambda x: jnp.zeros((max_length, *jnp.shape(x)), x.dtype), dummy_item
        )
        return ItemBufferState(
            experience=experience,
            current_index=jnp.int32(0),
            is_full=jnp.bool_(False),
        )

    def add(state: ItemBufferState, batch: Any) -> ItemBufferState:
        """batch leaves: (add_batch_size, ...). Non-wrapping writes lower to a
        contiguous dynamic_update_slice instead of a scatter; the wrap case keeps
        the modular scatter. Selected at runtime so any index history is safe."""
        first = jax.tree.leaves(batch)[0]
        assert first.shape[0] == add_batch_size, (
            f"add expects leading dim {add_batch_size}, got {first.shape[0]}"
        )
        idx = state.current_index

        def contiguous(exp):
            return jax.tree.map(
                lambda buf, x: jax.lax.dynamic_update_slice_in_dim(buf, x, idx, axis=0),
                exp,
                batch,
            )

        def wrapping(exp):
            positions = (idx + jnp.arange(add_batch_size)) % max_length
            return jax.tree.map(
                lambda buf, x: buf.at[positions].set(x), exp, batch
            )

        experience = jax.lax.cond(
            idx + add_batch_size <= max_length, contiguous, wrapping, state.experience
        )
        new_index = (state.current_index + add_batch_size) % max_length
        is_full = state.is_full | (state.current_index + add_batch_size >= max_length)
        return ItemBufferState(
            experience=experience,
            current_index=jnp.int32(new_index),
            is_full=is_full,
        )

    def can_sample(state: ItemBufferState) -> jnp.ndarray:
        size = jnp.where(state.is_full, max_length, state.current_index)
        return size >= min_length

    def sample(state: ItemBufferState, key: jnp.ndarray) -> SampleBatch:
        size = jnp.where(state.is_full, max_length, state.current_index)
        idx = jax.random.randint(key, (sample_batch_size,), 0, size)
        return SampleBatch(
            experience=jax.tree.map(lambda buf: buf[idx], state.experience)
        )

    return ItemBuffer(init=init, add=add, sample=sample, can_sample=can_sample)
