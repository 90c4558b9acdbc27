"""Test configuration.

Multi-device paths are exercised on a virtual 8-device CPU mesh. The CPU platform is
selected in-process (`jax.config.update`), so the suite runs on the CPU whether or not
`JAX_PLATFORMS` is set. Tests that need a card carry the `gpu` marker and the
`gpu_devices` fixture, which skips them where JAX finds no GPU.
"""

import os

# Must be set before jax initialises its backends.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# The suite runs on the CPU. On a machine with a card, MAVA_TEST_PLATFORMS=cuda,cpu
# also makes the GPU visible to the `gpu`-marked tests (python -m pytest -m gpu).
jax.config.update("jax_platforms", os.environ.get("MAVA_TEST_PLATFORMS", "cpu"))

import pytest  # noqa: E402


@pytest.fixture
def gpu_devices():
    """The GPUs JAX sees; skips the test where there are none."""
    try:
        return jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs a GPU (on the card: MAVA_TEST_PLATFORMS=cuda,cpu)")


@pytest.fixture
def fast_config_overrides():
    """Config shrinking for cheap end-to-end integration tests (the reference's test
    strategy, `test/conftest.py:20-48`): run everything, tiny sizes."""
    return [
        "system.num_updates=2",
        "arch.num_evaluation=1",
        "system.rollout_length=4",
        "arch.num_envs=2",
        "arch.num_eval_episodes=8",
        "arch.num_absolute_metric_eval_episodes=8",
        "arch.absolute_metric=False",
        # '+' form: sets the key for PPO systems and harmlessly adds it for
        # off-policy configs that don't have it (strict overrides otherwise reject
        # unknown keys).
        "+system.ppo_epochs=1",
        "+system.num_minibatches=2",
        "logger.use_console=False",
    ]
