"""Replay buffer semantics (SURVEY.md hard part #4)."""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.replay import make_item_buffer, make_trajectory_buffer


def _make(max_len=16, seq=4, add_b=2, sample_b=8, min_len=4):
    return make_trajectory_buffer(
        sample_sequence_length=seq,
        period=1,
        add_batch_size=add_b,
        sample_batch_size=sample_b,
        max_length_time_axis=max_len,
        min_length_time_axis=min_len,
    )


def test_trajectory_add_and_wrap():
    rb = _make()
    state = rb.init({"x": jnp.zeros((), jnp.int32)})
    # Write 0..5 then 6..11 then 12..17 (wraps at 16).
    for base in [0, 6, 12]:
        batch = {"x": jnp.arange(base, base + 6).reshape(1, 6).repeat(2, axis=0)}
        state = rb.add(state, batch)
    buf = np.asarray(state.experience["x"][0])
    # Ring: positions 0..15 hold 16,17,2..15.
    assert buf[0] == 16 and buf[1] == 17
    np.testing.assert_array_equal(buf[2:], np.arange(2, 16))
    assert bool(state.is_full)
    assert int(state.current_index) == 2


def test_trajectory_sampled_sequences_are_contiguous():
    rb = _make(max_len=16, seq=4, add_b=2, sample_b=64)
    state = rb.init({"x": jnp.zeros((), jnp.int32)})
    # Fill with a strictly increasing counter, wrapping twice.
    for base in range(0, 40, 8):
        batch = {"x": jnp.arange(base, base + 8).reshape(1, 8).repeat(2, axis=0)}
        state = rb.add(state, batch)
    sample = rb.sample(state, jax.random.PRNGKey(0)).experience["x"]
    diffs = np.diff(np.asarray(sample), axis=1)
    # Every sampled sequence is consecutive in insertion order (never spans the head).
    np.testing.assert_array_equal(diffs, np.ones_like(diffs))
    # And only contains live (most recent 16) values.
    assert np.asarray(sample).min() >= 40 - 16


def test_trajectory_can_sample_threshold():
    rb = _make(min_len=4)
    state = rb.init({"x": jnp.zeros((), jnp.int32)})
    assert not bool(rb.can_sample(state))
    state = rb.add(state, {"x": jnp.zeros((2, 4), jnp.int32)})
    assert bool(rb.can_sample(state))


def test_trajectory_sample_before_full_stays_in_written_region():
    rb = _make(max_len=16, seq=4, add_b=1, sample_b=128, min_len=4)
    state = rb.init({"x": jnp.zeros((), jnp.int32)})
    state = rb.add(state, {"x": jnp.arange(1, 7).reshape(1, 6)})  # values 1..6
    sample = np.asarray(rb.sample(state, jax.random.PRNGKey(1)).experience["x"])
    assert sample.min() >= 1 and sample.max() <= 6


def test_item_buffer_roundtrip_and_wrap():
    rb = make_item_buffer(
        max_length=8, min_length=2, sample_batch_size=32, add_batch_size=3
    )
    state = rb.init({"a": jnp.zeros((2,), jnp.float32)})
    for i in range(4):  # 12 items into capacity 8 -> wraps
        batch = {"a": jnp.full((3, 2), i, jnp.float32)}
        state = rb.add(state, batch)
    assert bool(state.is_full)
    sample = np.asarray(rb.sample(state, jax.random.PRNGKey(0)).experience["a"])
    # Only the last 8 items (values 1.33.. -> i in {1,2,3}) survive, value 0 evicted
    # partially: items 0..3 written at 0..8 -> positions 8..11 wrap to 0..3.
    assert set(np.unique(sample)) <= {1.0, 2.0, 3.0}


def test_buffers_jit_and_donate():
    rb = _make()
    state = rb.init({"x": jnp.zeros((3,), jnp.float32)})
    add = jax.jit(rb.add)
    sample = jax.jit(rb.sample)
    state = add(state, {"x": jnp.ones((2, 4, 3), jnp.float32)})
    out = sample(state, jax.random.PRNGKey(0))
    assert out.experience["x"].shape == (8, 4, 3)


def test_vault_roundtrip(tmp_path):
    import os

    from mava_jax.replay import Vault

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        vault = Vault("test_vault", vault_uid="u1")
        slab = {"obs": jnp.arange(24.0).reshape(2, 3, 4)}
        vault.write(slab)
        vault.write(slab)
        data = vault.read()
        # Leaves are named by pytree key path (offline consumers address
        # fields by name — examples/bc_from_vault.py).
        assert data["obs"].shape == (2, 6, 4)
    finally:
        os.chdir(cwd)


def test_vault_named_leaves_nested(tmp_path):
    """Key-path naming covers NamedTuple + dict nesting (the PPOTransition
    shape the experience-recording system writes)."""
    import os

    from mava_jax.replay import Vault
    from mava_jax.systems.ppo.types import PPOTransition
    from mava_jax.types import Observation

    tr = PPOTransition(
        done=jnp.zeros((2, 4, 3)),
        action=jnp.zeros((2, 4, 3), jnp.int32),
        value=jnp.zeros((2, 4, 3)),
        reward=jnp.zeros((2, 4, 3)),
        log_prob=jnp.zeros((2, 4, 3)),
        obs=Observation(
            agents_view=jnp.zeros((2, 4, 3, 7)),
            action_mask=jnp.ones((2, 4, 3, 5)),
            step_count=jnp.zeros((2, 4, 3), jnp.int32),
        ),
        info={"m": jnp.zeros((2, 4))},
    )
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        vault = Vault("test_vault_named", vault_uid="u1")
        vault.write(tr)
        data = vault.read()
        assert data[".obs.agents_view"].shape == (2, 4, 3, 7)
        assert data[".action"].shape == (2, 4, 3)
    finally:
        os.chdir(cwd)
