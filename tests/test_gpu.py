"""Checks that need the card. They skip on the CPU; on a machine with a GPU run
`MAVA_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mava_jax.networks import ScannedRNN

pytestmark = pytest.mark.gpu


def _gru_case(rows=256, hidden=128, steps=32, features=64):
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    xs = jax.random.normal(keys[0], (steps, rows, features))
    resets = jax.random.bernoulli(keys[1], 0.05, (steps, rows))
    carry = 0.1 * jax.random.normal(keys[2], (rows, hidden))
    params = ScannedRNN(hidden).init(jax.random.PRNGKey(1), carry, (xs[:1], resets[:1]))
    return params, carry, xs, resets


def _outputs_and_grads(impl, params, carry, xs, resets):
    net = ScannedRNN(carry.shape[-1], gru_impl=impl)

    def loss(p):
        final, ys = net.apply(p, carry, (xs, resets))
        return jnp.sum(final) + jnp.mean(ys)

    return jax.jit(lambda p: (net.apply(p, carry, (xs, resets)), jax.grad(loss)(p)))(params)


def _rel(a, b):
    a, b = jax.tree.leaves(a), jax.tree.leaves(b)
    diff = max(float(jnp.max(jnp.abs(x - y))) for x, y in zip(a, b))
    return diff / max(float(jnp.max(jnp.abs(y))) for y in b)


def test_hoisted_gru_matches_cell_on_gpu_at_highest(gpu_devices):
    case = jax.device_put(_gru_case(), gpu_devices[0])
    with jax.default_matmul_precision("highest"):
        hoisted = _outputs_and_grads("hoisted", *case)
        cell = _outputs_and_grads("cell", *case)
    assert _rel(hoisted, cell) <= 1e-5  # only the summation order differs


def test_gpu_matches_cpu_at_highest(gpu_devices):
    case = _gru_case()
    with jax.default_matmul_precision("highest"):
        on_gpu = _outputs_and_grads("hoisted", *jax.device_put(case, gpu_devices[0]))
        on_cpu = _outputs_and_grads("hoisted", *jax.device_put(case, jax.devices("cpu")[0]))
    assert _rel(jax.device_get(on_gpu), jax.device_get(on_cpu)) <= 1e-5


def test_default_precision_within_tf32_bound(gpu_devices):
    case = jax.device_put(_gru_case(), gpu_devices[0])
    default = _outputs_and_grads("hoisted", *case)
    with jax.default_matmul_precision("highest"):
        highest = _outputs_and_grads("hoisted", *case)
    assert _rel(default, highest) <= 1e-2


def test_ff_ippo_learn_call_on_gpu(gpu_devices):
    from mava_jax import envs as environments
    from mava_jax.parallel import make_mesh, num_learner_devices
    from mava_jax.systems.ppo import ff_ippo
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo",
        ["arch.num_envs=64", "system.rollout_length=16", "logger.use_console=False"],
    )
    mesh = make_mesh(gpu_devices[:1])
    cfg.arch.n_devices = num_learner_devices(mesh)
    cfg.system.num_updates_per_eval = 1
    env, _ = environments.make(cfg)
    learn, _, state = ff_ippo.learner_setup(
        env, tuple(jax.random.split(jax.random.PRNGKey(0), 3)), cfg, mesh
    )
    out = learn(state)
    for name, value in jax.device_get(out.train_metrics).items():
        assert np.all(np.isfinite(value)), name
    leaf = jax.tree.leaves(out.learner_state.params)[0]
    assert {d.platform for d in leaf.devices()} == {"gpu"}
