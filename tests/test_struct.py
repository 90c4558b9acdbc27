"""The in-repo pytree dataclass helper (`mava_jax.utils.struct`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax.utils import struct


@struct.dataclass
class State:
    x: jnp.ndarray
    y: dict
    n_agents: int = struct.field(pytree_node=False, default=2)


def _state():
    return State(x=jnp.arange(3.0), y={"a": jnp.ones((2,)), "b": jnp.zeros(())})


def test_fields_split_into_leaves_and_static():
    leaves, treedef = jax.tree.flatten(_state())
    assert len(leaves) == 3  # x, y.a, y.b — n_agents is static
    assert jax.tree.unflatten(treedef, leaves).n_agents == 2


def test_tree_map_round_trip():
    doubled = jax.tree.map(lambda v: v * 2, _state())
    assert isinstance(doubled, State) and doubled.n_agents == 2
    np.testing.assert_array_equal(doubled.x, jnp.arange(3.0) * 2)
    np.testing.assert_array_equal(doubled.y["a"], 2 * jnp.ones((2,)))


def test_jit_and_static_field_retrace():
    traces = []

    @jax.jit
    def f(s):
        traces.append(s.n_agents)
        return s.replace(x=s.x + s.n_agents)

    out = f(_state())
    np.testing.assert_array_equal(out.x, jnp.arange(3.0) + 2)
    f(_state())
    assert traces == [2]  # same static value: no retrace
    f(_state().replace(n_agents=5))
    assert traces == [2, 5]  # a static field is part of the cache key


def test_vmap_over_a_batch_of_states():
    batch = jax.vmap(lambda k: State(x=jax.random.normal(k, (3,)), y={"a": k, "b": 1.0}))(
        jax.random.split(jax.random.PRNGKey(0), 4)
    )
    assert batch.x.shape == (4, 3)
    sums = jax.vmap(lambda s: s.x.sum())(batch)
    assert sums.shape == (4,)


def test_frozen_and_replace():
    s = _state()
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.x = jnp.zeros(3)
    t = s.replace(x=jnp.zeros(3))
    np.testing.assert_array_equal(t.x, jnp.zeros(3))
    np.testing.assert_array_equal(s.x, jnp.arange(3.0))


def test_default_factory_field():
    @struct.dataclass
    class WithExtras:
        v: jnp.ndarray
        extras: dict = struct.field(default_factory=dict)

    w = WithExtras(jnp.ones(2))
    assert w.extras == {} and len(jax.tree.leaves(w)) == 1
