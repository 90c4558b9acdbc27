"""Environment factory and registry.

Parity with reference `mava/utils/make_env.py`: a registry keyed by env name, per-env
construction from config, and the fixed extra-wrapper order
(AgentID? -> AutoReset -> RecordEpisodeMetrics on train; RecordEpisodeMetrics on eval)
from `make_env.py:69-83`. The environments themselves are JAX-native implementations
shipped by this framework (no external env suites exist in the target image).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from mava_jax.envs.wrappers import (
    AgentIDWrapper,
    AutoResetWrapper,
    GlobalStateWrapper,
    RecordEpisodeMetrics,
)

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def _env_kwargs(config) -> Dict[str, Any]:
    """Merge scenario task_config + scenario env_kwargs + env-level kwargs."""
    kwargs = dict(config.env.scenario.get("task_config", {}))
    kwargs.update(config.env.scenario.get("env_kwargs", {}) or {})
    kwargs.update(config.env.get("kwargs", {}) or {})
    return kwargs


def register(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def _add_extra_wrappers(train_env, eval_env, config, add_global_state: bool):
    if add_global_state:
        train_env = GlobalStateWrapper(train_env)
        eval_env = GlobalStateWrapper(eval_env)
    if config.system.get("add_agent_id", False) and not config.env.get(
        "implicit_agent_id", False
    ):
        train_env = AgentIDWrapper(train_env)
        eval_env = AgentIDWrapper(eval_env)
    train_env = AutoResetWrapper(train_env)
    train_env = RecordEpisodeMetrics(train_env)
    eval_env = RecordEpisodeMetrics(eval_env)
    return train_env, eval_env


@register("RobotWarehouse")
def _make_rware(config) -> Tuple[Any, Any]:
    from mava_jax.envs.rware import RobotWarehouse

    kwargs = _env_kwargs(config)
    return RobotWarehouse(**kwargs), RobotWarehouse(**kwargs)


@register("LevelBasedForaging")
def _make_lbf(config) -> Tuple[Any, Any]:
    from mava_jax.envs.lbf import LevelBasedForaging

    kwargs = _env_kwargs(config)
    kwargs["use_individual_rewards"] = config.env.get("use_individual_rewards", False)
    return LevelBasedForaging(**kwargs), LevelBasedForaging(**kwargs)


@register("Smax")
def _make_smax(config) -> Tuple[Any, Any]:
    from mava_jax.envs.smax import Smax

    scenario = config.env.scenario.get("task_name", "3s5z")
    kwargs = dict(config.env.get("kwargs", {}))
    return Smax(scenario=scenario, **kwargs), Smax(scenario=scenario, **kwargs)


@register("Matrax")
def _make_matrax(config) -> Tuple[Any, Any]:
    from mava_jax.envs.matrax import Matrax

    kwargs = _env_kwargs(config)
    # Single override surface like the reference (`env.scenario.task_name=
    # Conflict-41-stateless-v0` selects any of the 160 registered names —
    # Climbing/Penalty/NoConflict-{0..20}/Conflict-{0..56}/Custom x state).
    # A scenario's task_config may pin its own task_name (the Custom-payoff
    # pattern, matrax-pd.yaml keeps both in sync) — but a CLI task_name that
    # CONTRADICTS the pin must fail loudly: the engine would train the pinned
    # task while JsonLogger labels the evidence with the CLI name.
    scenario_task = config.env.scenario.task_name
    if "task_name" in kwargs and kwargs["task_name"] != scenario_task:
        raise ValueError(
            f"Scenario pins task_config.task_name={kwargs['task_name']!r} but "
            f"env.scenario.task_name={scenario_task!r}. Pick a scenario without "
            "a task_config pin (e.g. env/scenario=matrax-climbing) to select "
            "tasks via env.scenario.task_name."
        )
    kwargs.setdefault("task_name", scenario_task)
    return Matrax(**kwargs), Matrax(**kwargs)


@register("Cleaner")
def _make_cleaner(config) -> Tuple[Any, Any]:
    from mava_jax.envs.cleaner import Cleaner

    kwargs = _env_kwargs(config)
    return Cleaner(**kwargs), Cleaner(**kwargs)


@register("MaConnector")
def _make_connector(config) -> Tuple[Any, Any]:
    from mava_jax.envs.connector import MaConnector

    kwargs = _env_kwargs(config)
    return MaConnector(**kwargs), MaConnector(**kwargs)


@register("MaSwarm")
def _make_maswarm(config) -> Tuple[Any, Any]:
    from mava_jax.envs.maswarm import MaSwarm

    kwargs = _env_kwargs(config)
    return MaSwarm(**kwargs), MaSwarm(**kwargs)


@register("MaReacher")
def _make_mareacher(config) -> Tuple[Any, Any]:
    from mava_jax.envs.mareacher import MaReacher

    kwargs = _env_kwargs(config)
    return MaReacher(**kwargs), MaReacher(**kwargs)


@register("MaSwimmer")
def _make_maswimmer(config) -> Tuple[Any, Any]:
    from mava_jax.envs.maswimmer import MaSwimmer

    kwargs = _env_kwargs(config)
    return MaSwimmer(**kwargs), MaSwimmer(**kwargs)


@register("MaHopper")
def _make_mahopper(config) -> Tuple[Any, Any]:
    from mava_jax.envs.mahopper import MaHopper

    kwargs = _env_kwargs(config)
    return MaHopper(**kwargs), MaHopper(**kwargs)


@register("MaCheetah")
def _make_macheetah(config) -> Tuple[Any, Any]:
    from mava_jax.envs.macheetah import MaCheetah

    kwargs = _env_kwargs(config)
    return MaCheetah(**kwargs), MaCheetah(**kwargs)


@register("MaAnt")
def _make_maant(config) -> Tuple[Any, Any]:
    from mava_jax.envs.maant import MaAnt

    kwargs = _env_kwargs(config)
    return MaAnt(**kwargs), MaAnt(**kwargs)


@register("MaHumanoid")
def _make_mahumanoid(config) -> Tuple[Any, Any]:
    from mava_jax.envs.mahumanoid import MaHumanoid

    kwargs = _env_kwargs(config)
    return MaHumanoid(**kwargs), MaHumanoid(**kwargs)


@register("MaWalker")
def _make_mawalker(config) -> Tuple[Any, Any]:
    from mava_jax.envs.mawalker import MaWalker

    kwargs = _env_kwargs(config)
    return MaWalker(**kwargs), MaWalker(**kwargs)


@register("Gigastep")
def _make_gigastep(config) -> Tuple[Any, Any]:
    from mava_jax.envs.gigastep import Gigastep

    kwargs = _env_kwargs(config)
    return Gigastep(**kwargs), Gigastep(**kwargs)


def make(config, add_global_state: bool = False) -> Tuple[Any, Any]:
    """Create (train_env, eval_env) from config (reference `make_env.py:215-240`)."""
    env_name = config.env.env_name
    if env_name not in _REGISTRY:
        raise ValueError(
            f"Unknown environment '{env_name}'. Available: {sorted(_REGISTRY)}"
        )
    train_env, eval_env = _REGISTRY[env_name](config)
    return _add_extra_wrappers(train_env, eval_env, config, add_global_state)
