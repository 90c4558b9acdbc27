"""Rapoport 2x2 catalog (matrax NoConflict-*/Conflict-* ids) — VERDICT r4 next-5."""

import numpy as np
import pytest

from mava_jax.envs.matrax import Matrax
from mava_jax.envs.matrax_catalog import (
    _CONFLICT,
    _NO_CONFLICT,
    canonical_id,
    catalog_payoff,
)


def test_taxonomy_counts_and_distinctness():
    # The published Rapoport & Guyer counts: 78 = 21 no-conflict + 57 conflict.
    assert len(_NO_CONFLICT) == 21 and len(_CONFLICT) == 57
    all_keys = set(_NO_CONFLICT) | set(_CONFLICT)
    assert len(all_keys) == 78
    # Every game is a pair of ordinal rankings.
    for fam, n in (("NoConflict", 21), ("Conflict", 57)):
        for i in range(n):
            p = catalog_payoff(fam, i)
            assert p.shape == (2, 2, 2) and p.dtype == np.float32
            for agent in range(2):
                assert sorted(p[agent].flatten()) == [1.0, 2.0, 3.0, 4.0]


def test_no_conflict_definition():
    # No-conflict: some cell is (4, 4); conflict: none is.
    for i in range(21):
        p = catalog_payoff("NoConflict", i)
        assert ((p[0] == 4) & (p[1] == 4)).any()
    for i in range(57):
        p = catalog_payoff("Conflict", i)
        assert not ((p[0] == 4) & (p[1] == 4)).any()


def test_well_known_games_land_at_documented_ids():
    """Prisoner's Dilemma / Chicken / Battle of the Sexes / Stag Hunt resolve to
    the ids pinned in the matrax_catalog docstring."""
    pd = ([[3, 1], [4, 2]], [[3, 4], [1, 2]])
    chicken = ([[3, 2], [4, 1]], [[3, 4], [2, 1]])
    bos = ([[4, 2], [1, 3]], [[3, 2], [1, 4]])
    stag = ([[4, 1], [3, 2]], [[4, 3], [1, 2]])
    assert canonical_id(*pd) == ("Conflict", 41)
    assert canonical_id(*chicken) == ("Conflict", 50)
    assert canonical_id(*bos) == ("Conflict", 42)
    assert canonical_id(*stag) == ("NoConflict", 19)


def test_catalog_ids_resolve_through_the_engine():
    import jax

    env = Matrax("Conflict-41-stateless-v0", time_limit=5)
    state, ts = env.reset(jax.random.PRNGKey(0))
    # PD (ordinal): mutual 'defect' is the unique Nash; verify the payoffs are
    # the canonical-form PD matrices the catalog stores.
    p = catalog_payoff("Conflict", 41)
    a0, a1 = np.asarray([0, 0]), np.asarray([1, 1])
    _, ts0 = env.step(state, a0)
    np.testing.assert_array_equal(np.asarray(ts0.reward), p[:, 0, 0])
    _, ts1 = env.step(state, a1)
    np.testing.assert_array_equal(np.asarray(ts1.reward), p[:, 1, 1])
    # Stateful variant works too.
    env_sf = Matrax("NoConflict-19-stateful-v0", time_limit=5)
    state, _ = env_sf.reset(jax.random.PRNGKey(0))
    st, ts = env_sf.step(state, np.asarray([1, 0]))
    np.testing.assert_array_equal(
        np.asarray(ts.observation.agents_view), [[1.0, 0.0], [1.0, 0.0]]
    )


def test_catalog_id_bounds_and_validation():
    with pytest.raises(ValueError, match=r"\[0, 20\]"):
        catalog_payoff("NoConflict", 21)
    with pytest.raises(ValueError, match=r"\[0, 56\]"):
        catalog_payoff("Conflict", 57)
    with pytest.raises(ValueError, match="family"):
        catalog_payoff("noconflict", 5)  # typo'd family must not alias Conflict
    with pytest.raises(ValueError, match="ordinal"):
        canonical_id([[1, 1], [2, 2]], [[1, 2], [3, 4]])


def test_contradicting_task_name_pin_fails_loudly():
    """A CLI task_name that contradicts a scenario's task_config pin must raise
    (the engine would train the pinned task while the JSON evidence is labeled
    with the CLI name)."""
    from mava_jax import envs as environments
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo",
        [
            "env=matrax",
            "env/scenario=matrax-pd",  # pins task_config.task_name=Custom-...
            "env.scenario.task_name=Conflict-41-stateless-v0",
            "logger.use_console=False",
        ],
    )
    with pytest.raises(ValueError, match="pins task_config.task_name"):
        environments.make(cfg)


def test_reference_matrax_config_ports_verbatim():
    """`env.scenario.task_name=Conflict-12-stateless-v0` — the reference's
    override surface (`mava/configs/env/matrax.yaml`) — builds the env through
    the factory with no scenario yaml per id."""
    from mava_jax import envs as environments
    from mava_jax.utils.config import load_config

    cfg = load_config(
        "default_ff_ippo",
        [
            "env=matrax",
            "env.scenario.task_name=Conflict-12-stateless-v0",
            "logger.use_console=False",
        ],
    )
    env, _ = environments.make(cfg)
    assert env.num_agents == 2 and env.action_dim == 2
    assert env.time_limit == 25  # reference default
