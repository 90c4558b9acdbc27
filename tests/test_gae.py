"""GAE vs a hand-written reference recursion (SURVEY.md hard part #1/#3)."""

import jax.numpy as jnp
import numpy as np

from mava_jax.ops import calculate_gae
from mava_jax.ops.gae import calculate_gae_with_next_done


def _reference_gae(rewards, values, dones, last_val, gamma, lam):
    T = len(rewards)
    adv = np.zeros(T)
    gae = 0.0
    next_value = last_val
    for t in reversed(range(T)):
        not_done = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * not_done - values[t]
        gae = delta + gamma * lam * not_done * gae
        adv[t] = gae
        next_value = values[t]
    return adv, adv + values


def test_gae_matches_reference_recursion():
    rng = np.random.RandomState(0)
    T = 13
    rewards = rng.randn(T).astype(np.float32)
    values = rng.randn(T).astype(np.float32)
    dones = (rng.rand(T) < 0.2).astype(np.float32)
    last_val = np.float32(rng.randn())

    adv_ref, tgt_ref = _reference_gae(rewards, values, dones, last_val, 0.99, 0.95)
    adv, tgt = calculate_gae(
        jnp.asarray(rewards),
        jnp.asarray(values),
        jnp.asarray(dones),
        jnp.asarray(last_val),
        0.99,
        0.95,
        unroll=4,
    )
    np.testing.assert_allclose(np.asarray(adv), adv_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tgt), tgt_ref, rtol=1e-5, atol=1e-5)


def test_gae_batched_shapes():
    T, E, A = 8, 4, 3
    rewards = jnp.ones((T, E, A))
    values = jnp.zeros((T, E, A))
    dones = jnp.zeros((T, E, A))
    last_val = jnp.zeros((E, A))
    adv, tgt = calculate_gae(rewards, values, dones, last_val, 0.99, 0.95)
    assert adv.shape == (T, E, A) and tgt.shape == (T, E, A)


def test_gae_next_done_variant_equals_shifted_done():
    """The recurrent systems store `last_done` in each transition (done BEFORE acting,
    reference `rec_ippo.py:138-146`), so transition.done[t] = done_ff[t-1] and the final
    done lives in `last_done`. Feeding the variant those shifted inputs must reproduce
    the feedforward GAE on the unshifted dones (reference recursion
    `rec_ippo.py:184-203` uses carry `next_done`)."""
    rng = np.random.RandomState(1)
    T = 9
    rewards = rng.randn(T).astype(np.float32)
    values = rng.randn(T).astype(np.float32)
    dones_ff = (rng.rand(T) < 0.3).astype(np.float32)
    last_val = np.float32(rng.randn())

    adv_ref, _ = _reference_gae(rewards, values, dones_ff, last_val, 0.99, 0.95)

    rec_dones = np.concatenate([[0.0], dones_ff[:-1]]).astype(np.float32)
    adv, _ = calculate_gae_with_next_done(
        jnp.asarray(rewards),
        jnp.asarray(values),
        jnp.asarray(rec_dones),
        jnp.asarray(dones_ff[-1]),
        jnp.asarray(last_val),
        0.99,
        0.95,
    )
    np.testing.assert_allclose(np.asarray(adv), adv_ref, rtol=1e-5, atol=1e-5)


def test_select_along_last_matches_take_along_axis():
    import jax
    import numpy as np

    from mava_jax.utils.jax_utils import select_along_last

    key = jax.random.PRNGKey(0)
    vals = jax.random.normal(key, (7, 3, 5))
    idx = jax.random.randint(key, (7, 3), 0, 5)
    expected = jnp.take_along_axis(vals, idx[..., None], axis=-1)[..., 0]
    np.testing.assert_allclose(select_along_last(vals, idx), expected, rtol=1e-6)


def test_pack_pytree_rows_bit_exact_roundtrip():
    import jax
    import numpy as np

    from mava_jax.utils.jax_utils import pack_pytree_rows

    n = 16
    key = jax.random.PRNGKey(3)
    tree = {
        "f": jax.random.normal(key, (n, 2, 5)),
        "weird": jnp.array([[np.nan, -0.0, np.inf, -np.inf]] * (n // 4)).reshape(
            n, 1
        ),
        "i": jax.random.randint(key, (n, 3), -(2**30), 2**30),
        "b": jax.random.bernoulli(key, 0.5, (n, 2, 4)),
        "scalar_rows": jax.random.normal(key, (n,)),
    }
    packed, unpack = pack_pytree_rows(tree, n)
    assert packed.shape == (n, 10 + 1 + 3 + 8 + 1)
    assert packed.dtype == jnp.int32

    out = unpack(packed)
    for k in tree:
        assert out[k].dtype == tree[k].dtype, k
        assert out[k].shape == tree[k].shape, k
        np.testing.assert_array_equal(
            np.asarray(out[k]).view(np.uint8), np.asarray(tree[k]).view(np.uint8)
        )

    # Row slices unpack with the sliced leading dim.
    half = unpack(packed[: n // 2])
    np.testing.assert_array_equal(
        np.asarray(half["f"]), np.asarray(tree["f"])[: n // 2]
    )

    # A permutation of packed rows unpacks to the same permutation of every leaf.
    perm = jax.random.permutation(key, n)
    permuted = unpack(jnp.take(packed, perm, axis=0))
    np.testing.assert_array_equal(
        np.asarray(permuted["i"]), np.asarray(tree["i"])[np.asarray(perm)]
    )
