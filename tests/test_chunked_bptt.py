"""Chunked-BPTT equivalence (VERDICT r1 item 5).

The recurrent systems re-run the GRU from each chunk's STORED initial hidden state
over time-contiguous chunks (`rec_ippo.py` chunk reshape; reference
`mava/systems/ppo/rec_ippo.py:344-365` uses time-strided chunks instead). Two exact
properties pin the implementation:

1. Forward equivalence at ANY chunk size: re-running each chunk from its stored
   input carry reproduces the full-sequence outputs (the chunking only truncates
   gradient flow, never changes the forward values). Since the input-projection
   hoist, the per-sequence `ins @ Wi` matmul tiles differently at different T, so
   the match is last-bit-tolerance rather than bitwise — the same accepted
   float-reassociation class as vmap batching (tests/test_vmap_seeds.py note).
2. Gradient equivalence when chunk boundaries coincide with episode boundaries
   (done=True at each chunk's first step): the carry is reset inside the cell, so
   truncation is a no-op and the summed chunked gradients EXACTLY equal the
   full-sequence gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.networks import ScannedRNN

T, B, A = 8, 4, 2
F = H = 6  # GRU output dim follows the carry width
CHUNK = 4


def _setup(done_at_chunk_boundaries: bool):
    key = jax.random.PRNGKey(0)
    k_x, k_w, k_init, k_done = jax.random.split(key, 4)
    x = jax.random.normal(k_x, (T, B, A, F))
    w = jax.random.normal(k_w, (T, B, A, F))  # GRU output dim = input dim (F)

    if done_at_chunk_boundaries:
        # Episode boundary exactly at each later chunk's first step.
        dones = jnp.zeros((T, B, A), dtype=bool).at[CHUNK].set(True)
    else:
        dones = jax.random.bernoulli(k_done, 0.3, (T, B, A))

    rnn = ScannedRNN(hidden_state_dim=H)
    rnn_collect = ScannedRNN(hidden_state_dim=H, collect_carries=True)
    h0 = ScannedRNN.initialize_carry((B, A), H)
    params = rnn.init(k_init, h0, (x, dones))
    return rnn, rnn_collect, params, h0, x, dones, w


def _full_loss(rnn, params, h0, x, dones, w):
    _, ys = rnn.apply(params, h0, (x, dones))
    return jnp.sum(ys * w)


def _chunked_loss(rnn, params, carries, x, dones, w):
    """Sum of per-chunk losses, each chunk re-run from its stored input carry
    (treated as data, like the system's traj_batch.hstates)."""
    total = 0.0
    for c in range(T // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        h_init = jax.lax.stop_gradient(carries[c * CHUNK])
        _, ys = rnn.apply(params, h_init, (x[sl], dones[sl]))
        total = total + jnp.sum(ys * w[sl])
    return total


def _stored_carries(rnn_collect, params, h0, x, dones):
    _, (carries, _) = rnn_collect.apply(params, h0, (x, dones))
    return carries


def test_chunked_forward_matches_full_any_dones():
    rnn, rnn_collect, params, h0, x, dones, w = _setup(False)
    _, ys_full = rnn.apply(params, h0, (x, dones))
    carries = _stored_carries(rnn_collect, params, h0, x, dones)
    for c in range(T // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        _, ys_chunk = rnn.apply(params, carries[c * CHUNK], (x[sl], dones[sl]))
        np.testing.assert_allclose(
            np.asarray(ys_full[sl]), np.asarray(ys_chunk), rtol=1e-5, atol=1e-6
        )


def test_chunked_grads_exact_when_boundaries_align_with_dones():
    rnn, rnn_collect, params, h0, x, dones, w = _setup(True)
    carries = _stored_carries(rnn_collect, params, h0, x, dones)

    g_full = jax.grad(lambda p: _full_loss(rnn, p, h0, x, dones, w))(params)
    g_chunk = jax.grad(lambda p: _chunked_loss(rnn, p, carries, x, dones, w))(params)

    for gf, gc in zip(jax.tree.leaves(g_full), jax.tree.leaves(g_chunk)):
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gc), rtol=1e-6, atol=1e-6)


def test_strided_layout_is_the_reference_reshape():
    """`chunk_layout=strided` must produce the reference's exact chunk layout
    (`mava/systems/ppo/rec_ippo.py:348-356`): the bare (T, E) -> (chunk, nc*E)
    reshape, where sequence j holds real time steps t = j//E + i*nc."""
    T_, E, chunk = 8, 3, 4
    nc = T_ // chunk
    labels = jnp.arange(T_)[:, None] * 1000 + jnp.arange(E)[None, :]  # t*1000+e
    strided = labels.reshape(chunk, nc * E)
    for j in range(nc * E):
        for i in range(chunk):
            t, e = i * nc + j // E, j % E
            assert int(strided[i, j]) == t * 1000 + e


def test_chunk_layouts_identical_at_default_chunk():
    """contiguous and strided are both the identity when chunk=rollout_length:
    one full rec-IPPO update must produce the same learner state under either
    (VERDICT r4 next-7 done-condition)."""
    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo import rec_ippo
    from mava_jax.utils.config import load_config

    def run(layout):
        cfg = load_config(
            "default_rec_ippo",
            [
                "env.kwargs.time_limit=8",
                "arch.num_envs=2",
                "system.rollout_length=4",
                "system.num_updates=1",
                "system.ppo_epochs=1",
                "system.num_minibatches=2",
                f"system.chunk_layout={layout}",
                "logger.use_console=False",
            ],
        )
        mesh = make_mesh()
        cfg.arch.n_devices = num_learner_devices(mesh)
        cfg.system.num_updates_per_eval = 1
        if cfg.system.recurrent_chunk_size is None:
            cfg.system.recurrent_chunk_size = cfg.system.rollout_length
        env, _ = environments.make(cfg)
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        learn, _, state = rec_ippo.learner_setup(env, tuple(keys), cfg, mesh)
        return jax.device_get(learn(state).learner_state)

    out_c = run("contiguous")
    out_s = run("strided")
    for c, s in zip(jax.tree.leaves(out_c), jax.tree.leaves(out_s)):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(s))


def test_unknown_chunk_layout_raises():
    import pytest

    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo import rec_ippo
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_rec_ippo",
        [
            "env.kwargs.time_limit=8",
            "arch.num_envs=2",
            "system.rollout_length=4",
            "system.num_updates=1",
            "system.chunk_layout=zigzag",
            "logger.use_console=False",
        ],
    )
    mesh = make_mesh()
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.num_updates_per_eval = 1
    if cfg.system.recurrent_chunk_size is None:
        cfg.system.recurrent_chunk_size = cfg.system.rollout_length
    env, _ = environments.make(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    learn, _, state = rec_ippo.learner_setup(env, tuple(keys), cfg, mesh)
    with pytest.raises(ValueError, match="chunk_layout"):
        learn(state)


def test_chunked_grads_truncate_only_cross_boundary_flow():
    """Sanity: at unaligned boundaries the losses still match exactly (forward
    identity) while gradients differ only by the truncated cross-chunk term."""
    rnn, rnn_collect, params, h0, x, dones, w = _setup(False)
    carries = _stored_carries(rnn_collect, params, h0, x, dones)

    l_full = _full_loss(rnn, params, h0, x, dones, w)
    l_chunk = _chunked_loss(rnn, params, carries, x, dones, w)
    # Per-chunk partial sums reassociate the fp32 reduction: identical values,
    # different rounding order.
    np.testing.assert_allclose(float(l_full), float(l_chunk), rtol=1e-5)

    g_full = jax.grad(lambda p: _full_loss(rnn, p, h0, x, dones, w))(params)
    g_chunk = jax.grad(lambda p: _chunked_loss(rnn, p, carries, x, dones, w))(params)
    diffs = [
        float(jnp.max(jnp.abs(gf - gc)))
        for gf, gc in zip(jax.tree.leaves(g_full), jax.tree.leaves(g_chunk))
    ]
    assert max(diffs) > 0.0  # truncation is real at unaligned boundaries
