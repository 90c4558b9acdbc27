"""Recurrent-training fidelity tests (SURVEY.md hard part #1).

The core invariant behind chunked BPTT: running ScannedRNN step-by-step while storing
carries, then re-running it in one scan from the stored initial carry, reproduces the
exact same outputs. If this breaks, recurrent PPO silently trains on wrong hidden
states.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mava_jax.networks import ScannedRNN


def _setup(T=6, B=3, A=2, F=8, H=8, seed=0):
    rnn = ScannedRNN(hidden_state_dim=H)
    xs = jax.random.normal(jax.random.PRNGKey(seed), (T, B, A, F))
    resets = jax.random.bernoulli(jax.random.PRNGKey(seed + 1), 0.3, (T, B, A))
    carry = ScannedRNN.initialize_carry((B, A), H)
    params = rnn.init(jax.random.PRNGKey(seed + 2), carry, (xs, resets))
    return rnn, params, xs, resets, carry


def test_scan_equals_stepwise():
    rnn, params, xs, resets, carry0 = _setup()
    T = xs.shape[0]

    # One scan over the full sequence.
    final_carry, ys_scan = rnn.apply(params, carry0, (xs, resets))

    # Step-by-step with carries threaded manually.
    carry = carry0
    ys = []
    for t in range(T):
        carry, y = rnn.apply(params, carry, (xs[t : t + 1], resets[t : t + 1]))
        ys.append(y[0])
    np.testing.assert_allclose(
        np.asarray(ys_scan), np.stack(ys), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(final_carry), np.asarray(carry), rtol=1e-5, atol=1e-6
    )


def test_reset_zeroes_carry():
    rnn, params, xs, _, carry0 = _setup()
    # All-resets at step 0: output must equal running from a zero carry.
    big_carry = jnp.ones_like(carry0) * 3.0
    resets = jnp.ones(xs.shape[:-1], dtype=bool)
    _, y_reset = rnn.apply(
        params, big_carry, (xs[:1], resets[:1])
    )
    _, y_zero = rnn.apply(
        params, carry0, (xs[:1], jnp.zeros_like(resets[:1]))
    )
    np.testing.assert_allclose(
        np.asarray(y_reset), np.asarray(y_zero), rtol=1e-5, atol=1e-6
    )


def test_chunked_rerun_matches_full_sequence():
    """Re-running the RNN per contiguous chunk from the stored chunk-initial carry
    must reproduce the full-sequence outputs — the property the rec-PPO loss relies
    on (`rec_ippo.py` loss re-run from `hstates[0]`)."""
    rnn, params, xs, resets, carry0 = _setup(T=8)
    T, chunk = 8, 4

    # Full pass, storing the carry before each step.
    carry = carry0
    carries = []
    ys_full = []
    for t in range(T):
        carries.append(carry)
        carry, y = rnn.apply(params, carry, (xs[t : t + 1], resets[t : t + 1]))
        ys_full.append(y[0])
    ys_full = np.stack(ys_full)

    # Chunked re-run from stored chunk-initial carries.
    for c in range(T // chunk):
        start = c * chunk
        _, ys_chunk = rnn.apply(
            params,
            carries[start],
            (xs[start : start + chunk], resets[start : start + chunk]),
        )
        np.testing.assert_allclose(
            np.asarray(ys_chunk), ys_full[start : start + chunk], rtol=1e-5, atol=1e-6
        )


def test_collect_carries_matches_stepwise_critic():
    """The post-rollout batched critic pass must reproduce exactly what the old
    in-rollout critic produced: per-step values AND per-step input hidden states,
    including around episode resets."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mava_jax.networks import RecurrentValueNet, ScannedRNN
    from mava_jax.networks.factory import make_torso
    from mava_jax.types import Observation

    T, E, A, F, H = 7, 3, 2, 5, 8
    torso = {"type": "MLPTorso", "layer_sizes": [H]}
    net = RecurrentValueNet(
        pre_torso=make_torso(torso), post_torso=make_torso(torso),
        hidden_state_dim=H,
    )
    net_carries = RecurrentValueNet(
        pre_torso=make_torso(torso), post_torso=make_torso(torso),
        hidden_state_dim=H, collect_carries=True,
    )

    key = jax.random.PRNGKey(0)
    obs = Observation(
        agents_view=jax.random.normal(key, (T, E, A, F)),
        action_mask=jnp.ones((T, E, A, 4), bool),
        step_count=jnp.zeros((T, E, A), jnp.int32),
    )
    dones = jax.random.bernoulli(key, 0.3, (T, E, A))
    h0 = ScannedRNN.initialize_carry((E, A), H) + 0.1  # non-zero start

    params = net.init(key, h0, (jax.tree.map(lambda x: x[:1], obs), dones[:1]))

    # Old style: one step at a time, storing each step's input carry.
    h = h0
    stepwise_vals, stepwise_carries = [], []
    for t in range(T):
        stepwise_carries.append(h)
        ob_t = jax.tree.map(lambda x: x[t : t + 1], obs)
        h, v = net.apply(params, h, (ob_t, dones[t : t + 1]))
        stepwise_vals.append(v[0])

    final_h, (carries, vals) = net_carries.apply(params, h0, (obs, dones))

    np.testing.assert_allclose(
        np.asarray(vals), np.asarray(jnp.stack(stepwise_vals)), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(carries), np.asarray(jnp.stack(stepwise_carries)), rtol=1e-6
    )
    np.testing.assert_allclose(np.asarray(final_h), np.asarray(h), rtol=1e-6)


def test_fused_gru_matches_flax_gru():
    """FusedGRUCell with packed flax params reproduces flax.linen.GRUCell exactly.

    The fused cell issues 2 wide matmuls instead of flax's 6 Dense kernels; this
    pins that the function computed is the same GRU (distribution-preserving perf
    transformation, CLAUDE.md invariant)."""
    from flax import linen as nn

    from mava_jax.networks.actor_critic import FusedGRUCell

    hidden, feat, batch = 32, 24, 7
    key = jax.random.PRNGKey(0)
    k_init, k_h, k_x = jax.random.split(key, 3)
    h0 = jax.random.normal(k_h, (batch, hidden))
    xs = jax.random.normal(k_x, (10, batch, feat))

    flax_cell = nn.GRUCell(features=hidden)
    flax_params = flax_cell.init(k_init, h0, xs[0])["params"]

    # Pack the 6 per-gate Dense kernels into the fused (in,3h)/(h,3h) layout.
    packed = {
        "wi": jnp.concatenate(
            [flax_params[g]["kernel"] for g in ("ir", "iz", "in")], axis=-1
        ),
        "bi": jnp.concatenate(
            [flax_params[g]["bias"] for g in ("ir", "iz", "in")], axis=-1
        ),
        "wh": jnp.concatenate(
            [flax_params[g]["kernel"] for g in ("hr", "hz", "hn")], axis=-1
        ),
        "bhn": flax_params["hn"]["bias"],
    }

    fused_cell = FusedGRUCell()
    h_flax, h_fused = h0, h0
    for t in range(xs.shape[0]):
        h_flax, y_flax = flax_cell.apply({"params": flax_params}, h_flax, xs[t])
        h_fused, y_fused = fused_cell.apply({"params": packed}, h_fused, xs[t])
        np.testing.assert_allclose(h_fused, h_flax, rtol=1e-6, atol=1e-6)


def test_fused_gru_recurrent_init_blocks_are_orthogonal():
    """Each (h,h) gate block of the fused recurrent kernel is orthogonal, matching
    flax GRUCell's per-gate orthogonal() recurrent init (not one fused draw)."""
    from mava_jax.networks.actor_critic import FusedGRUCell

    hidden, feat = 16, 16
    cell = FusedGRUCell()
    params = cell.init(
        jax.random.PRNGKey(3), jnp.zeros((2, hidden)), jnp.zeros((2, feat))
    )["params"]
    wh = params["wh"]
    assert wh.shape == (hidden, 3 * hidden)
    for i in range(3):
        block = wh[:, i * hidden : (i + 1) * hidden]
        np.testing.assert_allclose(
            block.T @ block, jnp.eye(hidden), rtol=1e-5, atol=1e-5
        )


def test_hoisted_scan_matches_legacy_cell_scan():
    """The hoisted ScannedRNN (input projection lifted out of the scan as one
    wide matmul) computes the same function — outputs, final carry, collected
    carries AND gradients — as the plain per-step cell path, which reads the
    same params (distribution-preserving perf transformation)."""
    T, B, A, F, H = 6, 3, 2, 5, 8
    xs = jax.random.normal(jax.random.PRNGKey(0), (T, B, A, F))
    resets = jax.random.bernoulli(jax.random.PRNGKey(1), 0.3, (T, B, A))
    carry0 = ScannedRNN.initialize_carry((B, A), H)

    for collect in (False, True):
        hoisted = ScannedRNN(hidden_state_dim=H, collect_carries=collect)
        cell = ScannedRNN(hidden_state_dim=H, collect_carries=collect, gru_impl="cell")
        params = hoisted.init(jax.random.PRNGKey(2), carry0, (xs, resets))
        assert jax.tree.structure(params) == jax.tree.structure(
            cell.init(jax.random.PRNGKey(2), carry0, (xs, resets))
        )

        def loss(net, p):
            final, ys = net.apply(p, carry0, (xs, resets))
            return jnp.sum(final**2) + sum(jnp.sum(y**2) for y in jax.tree.leaves(ys))

        out_h = hoisted.apply(params, carry0, (xs, resets))
        out_c = cell.apply(params, carry0, (xs, resets))
        grad_h = jax.grad(lambda p: loss(hoisted, p))(params)
        grad_c = jax.grad(lambda p: loss(cell, p))(params)

        for g, w in zip(jax.tree.leaves(out_h), jax.tree.leaves(out_c)):
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-6
            )
        for path, leaf in jax.tree_util.tree_flatten_with_path(grad_c)[0]:
            np.testing.assert_allclose(
                np.asarray(
                    grad_h["params"][path[-1].key]
                ),
                np.asarray(leaf),
                rtol=1e-5,
                atol=1e-6,
                err_msg=f"grad mismatch for {path[-1].key} (collect={collect})",
            )


def test_gru_impl_isolation_across_instances(monkeypatch):
    """Two ScannedRNN instances with DIFFERENT `gru_impl` fields coexist in one
    process (the impl used to be a mutable module global, so two recurrent
    systems built with different settings silently shared whichever was set
    last). Same params serve both; interleaved applies each trace their own
    path (proved by a spy on the impl each trace resolves)."""
    from mava_jax.networks import actor_critic

    T, B, A, F, H = 6, 3, 2, 5, 8
    xs = jax.random.normal(jax.random.PRNGKey(21), (T, B, A, F))
    resets = jax.random.bernoulli(jax.random.PRNGKey(22), 0.3, (T, B, A))
    carry0 = ScannedRNN.initialize_carry((B, A), H)

    rnn_hoisted = ScannedRNN(hidden_state_dim=H, gru_impl="hoisted")
    rnn_cell = ScannedRNN(hidden_state_dim=H, gru_impl="cell")
    params = rnn_hoisted.init(jax.random.PRNGKey(23), carry0, (xs, resets))

    traced = []
    orig = actor_critic.resolve_gru_impl

    def spy(impl=None):
        traced.append(orig(impl))
        return traced[-1]

    monkeypatch.setattr(actor_critic, "resolve_gru_impl", spy)
    out_c1 = rnn_cell.apply(params, carry0, (xs, resets))
    out_h = rnn_hoisted.apply(params, carry0, (xs, resets))
    out_c2 = rnn_cell.apply(params, carry0, (xs, resets))

    # Each instance traced its own path, even with the hoisted apply BETWEEN
    # two cell applies of the same params.
    assert traced == ["cell", "hoisted", "cell"]
    for a, b in zip(jax.tree.leaves(out_c1), jax.tree.leaves(out_h)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(out_c1), jax.tree.leaves(out_c2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resolve_gru_impl_platform_override():
    """`auto` (older configs) and None resolve to "hoisted" on every platform;
    a concrete impl passes through; an impl that no longer exists is refused
    rather than silently replaced."""
    import pytest

    from mava_jax.networks.actor_critic import resolve_gru_impl

    assert resolve_gru_impl("auto") == "hoisted"
    assert resolve_gru_impl(None) == "hoisted"
    assert resolve_gru_impl("hoisted") == "hoisted"
    assert resolve_gru_impl("cell") == "cell"
    with pytest.raises(ValueError, match="pallas"):
        resolve_gru_impl("pallas")
