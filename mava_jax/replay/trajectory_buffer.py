"""Trajectory replay buffer: a per-env ring buffer over a time axis with uniform
sequence sampling.

Replaces flashbax's `make_trajectory_buffer` (the reference's replay dependency,
`mava/systems/q_learning/rec_iql.py:160-168`) with a from-scratch implementation
designed for the compiled actor-learner step:

  * storage is a pytree with leaves (add_batch_size, max_length_time_axis, ...) living
    in HBM for the whole run — `add` and `sample` are pure functions traced into the
    same jit as acting/learning, so the buffer never leaves the device;
  * `add` writes a (add_batch_size, T_add, ...) slab at the ring head via a modular
    scatter along the time axis (static shapes; wrap handled uniformly);
  * `sample` draws (row, start) pairs uniformly over valid positions in the
    oldest->newest logical ordering, then gathers length-`sample_sequence_length`
    windows with a modular index take — sequences never span the write head;
  * all ops are static-shape; sampling uses one gather per leaf (HBM-bandwidth bound,
    no scatter).

API mirrors flashbax: `init(dummy) -> state`, `add(state, batch) -> state`,
`sample(state, key) -> SampleBatch(experience=...)`, `can_sample(state) -> bool`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from mava_jax.utils import struct


@struct.dataclass
class TrajectoryBufferState:
    experience: Any  # pytree, leaves (B_add, T_max, ...)
    current_index: jnp.ndarray  # () int32 — next write position on the time ring
    is_full: jnp.ndarray  # () bool


class SampleBatch(NamedTuple):
    experience: Any  # pytree, leaves (sample_batch_size, sample_sequence_length, ...)


class TrajectoryBuffer(NamedTuple):
    init: Any
    add: Any
    sample: Any
    can_sample: Any


def make_trajectory_buffer(
    sample_sequence_length: int,
    period: int,
    add_batch_size: int,
    sample_batch_size: int,
    max_length_time_axis: int,
    min_length_time_axis: int,
) -> TrajectoryBuffer:
    assert period == 1, "Only period=1 (any unique trajectory) is supported."
    assert sample_sequence_length <= max_length_time_axis

    def init(dummy_item: Any) -> TrajectoryBufferState:
        experience = jax.tree.map(
            lambda x: jnp.zeros(
                (add_batch_size, max_length_time_axis, *jnp.shape(x)), x.dtype
            ),
            dummy_item,
        )
        return TrajectoryBufferState(
            experience=experience,
            current_index=jnp.int32(0),
            is_full=jnp.bool_(False),
        )

    def add(state: TrajectoryBufferState, batch: Any) -> TrajectoryBufferState:
        """batch leaves: (add_batch_size, T_add, ...). Writes at the ring head.

        When the write fits without wrapping it lowers to a contiguous
        `dynamic_update_slice` instead of a modular scatter (hypothesis to A/B
        on the GPU: the slice is cheaper, ROADMAP S5). The
        wrap case keeps the scatter. Selected at runtime (`lax.cond` on a scalar
        predicate executes one branch), so mixed slab lengths stay correct."""
        first = jax.tree.leaves(batch)[0]
        t_add = first.shape[1]
        assert first.shape[0] == add_batch_size, (
            f"add expects leading dim {add_batch_size}, got {first.shape[0]}"
        )
        idx = state.current_index

        def contiguous(exp):
            return jax.tree.map(
                lambda buf, x: jax.lax.dynamic_update_slice_in_dim(
                    buf, x, idx, axis=1
                ),
                exp,
                batch,
            )

        def wrapping(exp):
            positions = (idx + jnp.arange(t_add)) % max_length_time_axis
            return jax.tree.map(
                lambda buf, x: buf.at[:, positions].set(x), exp, batch
            )

        experience = jax.lax.cond(
            idx + t_add <= max_length_time_axis,
            contiguous,
            wrapping,
            state.experience,
        )
        new_index = (idx + t_add) % max_length_time_axis
        is_full = state.is_full | (idx + t_add >= max_length_time_axis)
        return TrajectoryBufferState(
            experience=experience,
            current_index=jnp.int32(new_index),
            is_full=is_full,
        )

    def can_sample(state: TrajectoryBufferState) -> jnp.ndarray:
        size = jnp.where(
            state.is_full, max_length_time_axis, state.current_index
        )
        return size >= min_length_time_axis

    def sample(state: TrajectoryBufferState, key: jnp.ndarray) -> SampleBatch:
        row_key, start_key = jax.random.split(key)
        size = jnp.where(state.is_full, max_length_time_axis, state.current_index)
        # Oldest element sits at current_index when full, else at 0.
        oldest = jnp.where(state.is_full, state.current_index, 0)
        num_starts = jnp.maximum(size - sample_sequence_length + 1, 1)

        rows = jax.random.randint(
            row_key, (sample_batch_size,), 0, add_batch_size
        )
        logical_starts = jax.random.randint(
            start_key, (sample_batch_size,), 0, num_starts
        )
        physical_starts = (oldest + logical_starts) % max_length_time_axis
        # (sample_batch_size, seq_len) gather indices on the time ring.
        time_idx = (
            physical_starts[:, None] + jnp.arange(sample_sequence_length)[None, :]
        ) % max_length_time_axis

        experience = jax.tree.map(
            lambda buf: buf[rows[:, None], time_idx], state.experience
        )
        return SampleBatch(experience=experience)

    return TrajectoryBuffer(init=init, add=add, sample=sample, can_sample=can_sample)
