"""Config composition and override semantics."""

import pytest

from mava_jax.utils.config import load_config


def test_default_composition():
    cfg = load_config("default_ff_ippo")
    assert cfg.env.env_name == "RobotWarehouse"
    assert cfg.env.scenario.task_name == "tiny-2ag"
    assert cfg.system.rollout_length == 128
    assert cfg.arch.num_envs == 16
    assert cfg.logger.system_name == "ff_ippo"


def test_leaf_override():
    cfg = load_config("default_ff_ippo", ["system.gamma=0.9", "arch.num_envs=4"])
    assert cfg.system.gamma == 0.9
    assert cfg.arch.num_envs == 4


def test_scenario_switch():
    cfg = load_config("default_ff_ippo", ["env.scenario=tiny-4ag"])
    assert cfg.env.scenario.task_config.num_agents == 4


def test_new_key_injection():
    cfg = load_config("default_ff_ippo")
    cfg.system.num_agents = 7  # struct-mode-off equivalent
    assert cfg.system.num_agents == 7


def test_bad_override_raises():
    with pytest.raises(ValueError):
        load_config("default_ff_ippo", ["notakeyvalue"])


def test_hydra_style_scenario_switch():
    # The reference CLI syntax (`README.md:170-183`): env/scenario=<name>.
    cfg = load_config("default_rec_ippo", ["env=smax", "env/scenario=3s5z"])
    assert cfg.env.scenario.task_name == "3s5z"


def test_unknown_override_key_rejected():
    with pytest.raises(KeyError):
        load_config("default_ff_ippo", ["system.no_such_key=1"])
    with pytest.raises(KeyError):
        load_config("default_ff_ippo", ["system.typo.deep=1"])


def test_plus_prefix_adds_new_key():
    cfg = load_config("default_ff_ippo", ["+system.brand_new=3"])
    assert cfg.system.brand_new == 3


def test_group_switch_with_scenario():
    cfg = load_config("default_ff_ippo", ["env=lbf", "env/scenario=15x15-4p-3f"])
    assert cfg.env.env_name == "LevelBasedForaging"
    assert cfg.env.scenario.task_name == "15x15-4p-3f"
