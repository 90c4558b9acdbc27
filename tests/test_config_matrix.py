"""Every default config composes; every env/scenario pair loads and self-describes."""

from pathlib import Path

import pytest

from mava_jax.utils.config import CONFIG_DIR, load_config

DEFAULTS = sorted(p.stem for p in Path(CONFIG_DIR).glob("default_*.yaml"))
ENVS = sorted(p.stem for p in (Path(CONFIG_DIR) / "env").glob("*.yaml"))
SCENARIOS = sorted(
    p.stem for p in (Path(CONFIG_DIR) / "env" / "scenario").glob("*.yaml")
)

# scenario prefix -> env group that owns it
_SCENARIO_ENV = {
    "tiny": "rware", "small": "rware",
    "2s-": "lbf", "8x8": "lbf", "10x10": "lbf", "15x15": "lbf",
    "2s3z": "smax", "3s5z": "smax", "3s_vs": "smax", "5m": "smax", "6h": "smax",
    "10m": "smax", "27m": "smax", "smacv2": "smax",
    "clean": "cleaner", "con-": "connector",
    "hide": "gigastep", "waypoint": "gigastep",
    "matrax": "matrax", "spread": "maswarm", "reacher": "mareacher",
    "swimmer": "maswimmer", "hopper": "mahopper", "halfcheetah": "macheetah",
    "walker2d": "mawalker", "ant": "maant", "humanoid": "mahumanoid",
}


def _env_for(scenario: str) -> str:
    for prefix, env in _SCENARIO_ENV.items():
        if scenario.startswith(prefix):
            return env
    raise AssertionError(f"No env mapping for scenario '{scenario}' — extend the map.")


@pytest.mark.parametrize("default", DEFAULTS)
def test_default_composes(default):
    cfg = load_config(default)
    assert cfg.env.env_name
    assert cfg.logger.system_name
    assert "rollout_length" in cfg.system or "explore_steps" in cfg.system


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_scenario_loads(scenario):
    env = _env_for(scenario)
    cfg = load_config("default_ff_ippo", [f"env={env}", f"env/scenario={scenario}"])
    assert cfg.env.scenario.task_name or cfg.env.scenario.get("task_config") is not None


@pytest.mark.parametrize("env", ENVS)
def test_every_env_group_composes(env):
    cfg = load_config("default_ff_ippo", [f"env={env}"])
    assert cfg.env.env_name
