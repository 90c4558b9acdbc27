"""Env viewers (`mava_jax/envs/render.py`): every registered renderer produces
RGB frames from real reset/step states, and GIF export writes a file."""

import os

import jax
import numpy as np
import pytest

from mava_jax import specs
from mava_jax.envs.cleaner import Cleaner
from mava_jax.envs.connector import MaConnector
from mava_jax.envs.gigastep import Gigastep
from mava_jax.envs.lbf import LevelBasedForaging
from mava_jax.envs.maant import MaAnt
from mava_jax.envs.macheetah import MaCheetah
from mava_jax.envs.mahopper import MaHopper
from mava_jax.envs.mahumanoid import MaHumanoid
from mava_jax.envs.mareacher import MaReacher
from mava_jax.envs.maswarm import MaSwarm
from mava_jax.envs.maswimmer import MaSwimmer
from mava_jax.envs.mawalker import MaWalker
from mava_jax.envs.render import render_frame, rollout_episode, save_gif
from mava_jax.envs.rware import RobotWarehouse
from mava_jax.envs.smax import Smax

ENVS = [
    RobotWarehouse(
        shelf_rows=1, shelf_columns=3, column_height=8, num_agents=2,
        sensor_range=1, request_queue_size=2, time_limit=16,
    ),
    LevelBasedForaging(),
    Cleaner(),
    MaConnector(),
    Smax(scenario="2s3z"),
    MaSwarm(),
    MaReacher(),
    MaSwimmer(),
    MaHopper(),
    MaWalker(),
    MaCheetah(),
    Gigastep(scenario="waypoint"),
    MaAnt(),
    MaHumanoid(),
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: type(e).__name__)
def test_render_frame_shapes(env):
    state, ts = env.reset(jax.random.PRNGKey(0))
    frame = render_frame(env, state)
    assert frame.dtype == np.uint8 and frame.ndim == 3 and frame.shape[2] == 3
    # Step once and render again — frames must stay stable in shape.
    if isinstance(env.action_spec(), specs.DiscreteArray):
        action = jax.numpy.zeros((env.num_agents,), dtype=jax.numpy.int32)
    else:
        action = jax.numpy.zeros((env.num_agents, env.action_dim))
    state, _ = env.step(state, action)
    assert render_frame(env, state).shape == frame.shape


def test_rollout_and_gif(tmp_path):
    env = Cleaner(time_limit=5)

    def random_act(ts, key):
        return jax.random.randint(key, (env.num_agents,), 0, env.action_dim)

    frames, ep_return = rollout_episode(env, random_act, jax.random.PRNGKey(0))
    assert 2 <= len(frames) <= 6
    path = save_gif(frames, str(tmp_path / "ep.gif"))
    assert os.path.getsize(path) > 0
