"""Buffer donation through `parallel.mesh.build_learner`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mava_jax.parallel.mesh import build_learner, make_mesh, unaliased


def _step(state):
    return jax.tree.map(lambda v: v + 1, state)


def test_donating_an_aliased_state_works():
    """Two state fields may share one device buffer (XLA can return one buffer
    for two equal outputs); a plain donating jit refuses that state, the
    learner built with donation copies the alias first."""
    mesh = make_mesh(jax.devices()[:1])
    shared = jnp.zeros((4,))
    plain = jax.jit(_step, donate_argnums=0)
    with pytest.raises(Exception, match="donate the same buffer twice"):
        plain({"x": shared, "y": shared})

    learn = build_learner(_step, mesh, (P(),), P(), donate=True)
    shared = jnp.zeros((4,))
    out = learn({"x": shared, "y": shared})
    np.testing.assert_array_equal(out["x"], np.ones(4))
    np.testing.assert_array_equal(out["y"], np.ones(4))
    out = learn(out)  # and the outputs feed the next call
    np.testing.assert_array_equal(out["y"], 2 * np.ones(4))


def test_unaliased_copies_only_repeats():
    a, b = jnp.ones(3), jnp.zeros(3)
    tree = {"a": a, "a2": a, "b": b, "n": 3}
    out = unaliased(tree)
    assert out["a"] is a and out["b"] is b and out["n"] == 3
    assert out["a2"] is not a
    assert (
        out["a2"].addressable_shards[0].data.unsafe_buffer_pointer()
        != a.addressable_shards[0].data.unsafe_buffer_pointer()
    )


def test_learner_without_donation_is_plain_jit():
    mesh = make_mesh(jax.devices()[:1])
    learn = build_learner(_step, mesh, (P(),), P(), donate=False)
    x = jnp.zeros(2)
    learn({"x": x})
    assert not x.is_deleted()
    assert hasattr(learn, "lower")
