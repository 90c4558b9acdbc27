"""SMAX: simplified StarCraft multi-agent combat, implemented natively in JAX.

The reference wraps JaxMARL's SMAX (`mava/wrappers/jaxmarl.py:326-373`); this is our own
engine with the same task structure: two teams of heterogeneous units on a continuous
2D map, discrete per-unit actions (stop, 4 move directions, attack-enemy-i), a scripted
enemy controller, SMAC-style shaped rewards normalised to a 20-point scale, and win
detection (all enemies dead) surfaced through `extras["won_episode"]`.

Engine semantics (documented, self-contained — unit stats are SC2-flavoured but ours):
  * each env step = ~0.5 game seconds; movement = speed * 0.5 in one of 4 directions,
    clipped to the map; attacking units don't move;
  * an attack on enemy e is legal iff both units are alive and e is within the
    attacker's attack range at the step start; damage = per-step dps of the attacker;
  * simultaneous damage resolution (all attacks land, then deaths are applied);
  * heuristic enemy AI: attack the closest (or a random, `attack_mode`) ally in range,
    else move toward the closest ally;
  * team reward per step = (damage dealt + 10 * kills + 200 * win) / max_reward * 20,
    max_reward = total enemy hp + 10 * n_enemies + 200 (SMAC convention);
  * episode ends when either team is wiped (termination) or at time_limit (truncation);
  * observation per agent: own [hp_frac, x/W, y/H, type-onehot] then for every other
    unit (allies first, then enemies): [visible, hp_frac, rel_x/sight, rel_y/sight,
    type-onehot]; dead units observe zeros;
  * global state: every unit's [hp_frac, x/W, y/H, type-onehot], identical per agent
    (SMAX "world state", used by centralised critics);
  * smacv2_* scenarios resample unit types and start positions every reset.

Scenarios: 2s3z, 3s5z, 5m_vs_6m, 10m_vs_11m, 27m_vs_30m, 3s5z_vs_3s6z, 3s_vs_5z,
6h_vs_8z, smacv2_5_units, smacv2_10_units, smacv2_20_units.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

# Unit stats: [hp, dps (per env step), attack_range, sight_range, speed]
_UNIT_NAMES = [
    "marine", "marauder", "stalker", "zealot", "zergling", "hydralisk", "colossus",
]
_UNIT_STATS = np.array(
    [
        # hp     dps    atk_r  sight  speed
        [45.0, 10.0, 5.0, 9.0, 3.15],  # marine
        [125.0, 9.0, 6.0, 10.0, 3.15],  # marauder
        [160.0, 10.0, 6.0, 10.0, 4.13],  # stalker (hp+shield)
        [150.0, 18.0, 1.5, 9.0, 3.15],  # zealot (hp+shield, melee)
        [35.0, 10.0, 1.0, 8.0, 4.70],  # zergling
        [80.0, 20.0, 5.0, 9.0, 3.15],  # hydralisk
        [350.0, 19.0, 7.0, 10.0, 3.15],  # colossus
    ],
    dtype=np.float32,
)
NUM_UNIT_TYPES = len(_UNIT_NAMES)

MAP_WIDTH = 32.0
MAP_HEIGHT = 32.0
_STEP_SCALE = 0.5  # game seconds per env step
_MOVE_DIRS = np.array(
    [[0.0, 1.0], [1.0, 0.0], [0.0, -1.0], [-1.0, 0.0]], dtype=np.float32
)  # N, E, S, W in (x, y)

_T = {name: i for i, name in enumerate(_UNIT_NAMES)}


def _comp(counts: Dict[str, int]) -> List[int]:
    out: List[int] = []
    for name, n in counts.items():
        out += [_T[name]] * n
    return out


# scenario -> (ally unit types, enemy unit types, time_limit, smacv2 pool size or None)
_SCENARIOS: Dict[str, Tuple[List[int], List[int], int]] = {
    "2s3z": (_comp({"stalker": 2, "zealot": 3}), _comp({"stalker": 2, "zealot": 3}), 120),
    "3s5z": (_comp({"stalker": 3, "zealot": 5}), _comp({"stalker": 3, "zealot": 5}), 150),
    "5m_vs_6m": (_comp({"marine": 5}), _comp({"marine": 6}), 120),
    "10m_vs_11m": (_comp({"marine": 10}), _comp({"marine": 11}), 150),
    "27m_vs_30m": (_comp({"marine": 27}), _comp({"marine": 30}), 180),
    "3s5z_vs_3s6z": (
        _comp({"stalker": 3, "zealot": 5}),
        _comp({"stalker": 3, "zealot": 6}),
        170,
    ),
    "3s_vs_5z": (_comp({"stalker": 3}), _comp({"zealot": 5}), 200),
    "6h_vs_8z": (_comp({"hydralisk": 6}), _comp({"zealot": 8}), 150),
    "smacv2_5_units": ([0] * 5, [0] * 5, 150),
    "smacv2_10_units": ([0] * 10, [0] * 10, 150),
    "smacv2_20_units": ([0] * 20, [0] * 20, 150),
}
_SMACV2_POOL = np.array(
    [_T["marine"], _T["marauder"], _T["stalker"], _T["zealot"], _T["hydralisk"]],
    dtype=np.int32,
)


@struct.dataclass
class SmaxState:
    key: PRNGKey
    step_count: jnp.ndarray  # ()
    unit_pos: jnp.ndarray  # (N, 2) float32 (x, y)
    unit_hp: jnp.ndarray  # (N,) float32
    unit_types: jnp.ndarray  # (N,) int32
    max_reward: jnp.ndarray  # () float32


class Smax:
    def __init__(
        self,
        scenario: str = "3s5z",
        see_enemy_actions: bool = True,  # accepted for config parity
        walls_cause_death: bool = True,  # no walls in this engine; accepted
        attack_mode: str = "closest",
        time_limit: int | None = None,
    ):
        if scenario not in _SCENARIOS:
            raise ValueError(f"Unknown SMAX scenario '{scenario}'.")
        ally_types, enemy_types, default_limit = _SCENARIOS[scenario]
        self.scenario = scenario
        self.is_smacv2 = scenario.startswith("smacv2")
        self.num_agents = len(ally_types)
        self.num_enemies = len(enemy_types)
        self.num_units = self.num_agents + self.num_enemies
        self.time_limit = int(time_limit or default_limit)
        self.attack_mode = attack_mode
        self.action_dim = 5 + self.num_enemies  # stop, 4 moves, attack each enemy

        self._init_types = jnp.asarray(
            np.array(ally_types + enemy_types, dtype=np.int32)
        )
        self._stats = jnp.asarray(_UNIT_STATS)
        self._move_dirs = jnp.asarray(_MOVE_DIRS)
        if not self.is_smacv2:
            # Unit types are fixed for the scenario (reset always restores
            # _init_types), so per-unit stats are compile-time constants — no
            # per-step gathers from the stats table.
            static = _UNIT_STATS[np.array(ally_types + enemy_types)]
            self._static_stats = jnp.asarray(static)  # (N, 5)
            self._static_type_onehot = jnp.asarray(
                np.eye(NUM_UNIT_TYPES, dtype=np.float32)[
                    np.array(ally_types + enemy_types)
                ]
            )

        per_other = 4 + NUM_UNIT_TYPES
        self.num_obs_features = (3 + NUM_UNIT_TYPES) + (
            self.num_units - 1
        ) * per_other
        self.global_state_features = self.num_units * (3 + NUM_UNIT_TYPES)

    # ------------------------------------------------------------------ reset
    def reset(self, key: PRNGKey) -> Tuple[SmaxState, TimeStep]:
        key, pos_key, type_key = jax.random.split(key, 3)

        if self.is_smacv2:
            unit_types = jax.random.choice(
                type_key, jnp.asarray(_SMACV2_POOL), shape=(self.num_units,)
            ).astype(jnp.int32)
            ally_center = jnp.array([MAP_WIDTH * 0.3, MAP_HEIGHT * 0.5])
            enemy_center = jnp.array([MAP_WIDTH * 0.7, MAP_HEIGHT * 0.5])
            scatter = 4.0
        else:
            unit_types = self._init_types
            ally_center = jnp.array([MAP_WIDTH * 0.25, MAP_HEIGHT * 0.5])
            enemy_center = jnp.array([MAP_WIDTH * 0.75, MAP_HEIGHT * 0.5])
            scatter = 2.0

        noise = jax.random.normal(pos_key, (self.num_units, 2)) * scatter
        centers = jnp.concatenate(
            [
                jnp.tile(ally_center, (self.num_agents, 1)),
                jnp.tile(enemy_center, (self.num_enemies, 1)),
            ]
        )
        unit_pos = jnp.clip(
            centers + noise,
            jnp.array([1.0, 1.0]),
            jnp.array([MAP_WIDTH - 1.0, MAP_HEIGHT - 1.0]),
        )

        unit_hp = self._stats[unit_types, 0]
        enemy_hp_total = jnp.sum(unit_hp[self.num_agents :])
        max_reward = enemy_hp_total + 10.0 * self.num_enemies + 200.0

        state = SmaxState(
            key=key,
            step_count=jnp.int32(0),
            unit_pos=unit_pos,
            unit_hp=unit_hp,
            unit_types=unit_types,
            max_reward=max_reward,
        )
        obs = self._observe(state)
        extras = {"won_episode": jnp.bool_(False)}
        return state, restart(obs, extras, self.num_agents)

    # ------------------------------------------------------------------ obs
    def _unit_stats(self, state: SmaxState) -> jnp.ndarray:
        """(N, 5) per-unit [hp, dps, atk_range, sight, speed] — static constants for
        fixed-composition scenarios, gathered only for smacv2 (resampled types)."""
        if self.is_smacv2:
            return self._stats[state.unit_types]
        return self._static_stats

    def _type_onehot(self, state: SmaxState) -> jnp.ndarray:
        if self.is_smacv2:
            return jax.nn.one_hot(state.unit_types, NUM_UNIT_TYPES)
        return self._static_type_onehot

    def _unit_feats(self, state: SmaxState) -> jnp.ndarray:
        """(N, 3 + T): [hp_frac, x/W, y/H, type-onehot], zeroed for dead units."""
        alive = state.unit_hp > 0
        max_hp = self._unit_stats(state)[:, 0]
        feats = jnp.concatenate(
            [
                (state.unit_hp / max_hp)[:, None],
                state.unit_pos / jnp.array([MAP_WIDTH, MAP_HEIGHT]),
                self._type_onehot(state),
            ],
            axis=-1,
        )
        return feats * alive[:, None]

    def _observe(self, state: SmaxState) -> Observation:
        n, a = self.num_units, self.num_agents
        alive = state.unit_hp > 0
        stats = self._unit_stats(state)
        max_hp = stats[:, 0]
        hp_frac = state.unit_hp / max_hp
        sight = stats[:, 3]
        type_onehot = self._type_onehot(state)

        own = jnp.concatenate(
            [
                hp_frac[:a, None],
                state.unit_pos[:a] / jnp.array([MAP_WIDTH, MAP_HEIGHT]),
                type_onehot[:a],
            ],
            axis=-1,
        ) * alive[:a, None]

        rel = state.unit_pos[None, :, :] - state.unit_pos[:a, None, :]  # (A, N, 2)
        dist = jnp.linalg.norm(rel, axis=-1)
        visible = (dist <= sight[:a, None]) & alive[None, :] & alive[:a, None]

        other = jnp.concatenate(
            [
                visible[..., None].astype(jnp.float32),
                jnp.broadcast_to(hp_frac[None, :, None], (a, n, 1)),
                rel / jnp.maximum(sight[:a, None, None], 1e-6),
                jnp.broadcast_to(type_onehot[None], (a, n, NUM_UNIT_TYPES)),
            ],
            axis=-1,
        ) * visible[..., None]  # (A, N, 4+T)

        # Drop self from the per-agent rows: roll each row so self is first, cut it.
        idx = (jnp.arange(n)[None, :] + jnp.arange(a)[:, None]) % n  # self first
        other = jnp.take_along_axis(other, idx[..., None], axis=1)[:, 1:]
        agents_view = jnp.concatenate([own, other.reshape(a, -1)], axis=-1)

        # Action mask shares this obs pass's ally-enemy distances (no recompute).
        ally_alive = alive[:a]
        stop_ok = jnp.ones((a, 1), dtype=jnp.bool_)
        move_ok = jnp.broadcast_to(ally_alive[:, None], (a, 4))
        atk_range = stats[:a, 2]
        attack_ok = (
            (dist[:, a:] <= atk_range[:, None])
            & alive[None, a:]
            & ally_alive[:, None]
        )
        action_mask = jnp.concatenate([stop_ok, move_ok, attack_ok], axis=-1)

        step_count = jnp.repeat(state.step_count, a)
        return Observation(agents_view, action_mask, step_count)

    # ------------------------------------------------------------------ step
    def _enemy_actions(
        self,
        state: SmaxState,
        key: PRNGKey,
        rel: jnp.ndarray,  # (E, A, 2) ally pos relative to each enemy
        dist: jnp.ndarray,  # (E, A)
    ) -> jnp.ndarray:
        """Scripted controller for the enemy team: attack in-range allies
        (closest or random), else advance on the closest ally. Distances come from
        the step's shared pairwise matrix."""
        a, e = self.num_agents, self.num_enemies
        alive = state.unit_hp > 0
        dist = jnp.where(alive[None, :a], dist, jnp.inf)

        atk_range = self._unit_stats(state)[a:, 2]
        in_range = dist <= atk_range[:, None]

        if self.attack_mode == "random":
            noise = jax.random.uniform(key, dist.shape)
            target_score = jnp.where(in_range, noise, -jnp.inf)
        else:  # closest
            target_score = jnp.where(in_range, -dist, -jnp.inf)
        target = jnp.argmax(target_score, axis=-1)  # (E,)
        can_attack = jnp.any(in_range, axis=-1)

        # Movement: pick the cardinal direction that most reduces distance to the
        # closest ally.
        closest = jnp.argmin(dist, axis=-1)
        to_target = rel[jnp.arange(e), closest]  # (E, 2)
        dir_scores = to_target @ self._move_dirs.T  # (E, 4)
        move_action = 1 + jnp.argmax(dir_scores, axis=-1)

        any_ally_alive = jnp.any(alive[:a])
        action = jnp.where(can_attack, 5 + target, move_action)
        action = jnp.where(any_ally_alive, action, 0)
        action = jnp.where(alive[a:], action, 0)
        return action.astype(jnp.int32)

    def step(self, state: SmaxState, action: jnp.ndarray) -> Tuple[SmaxState, TimeStep]:
        a, e, n = self.num_agents, self.num_enemies, self.num_units
        key, enemy_key = jax.random.split(state.key)

        # Pairwise geometry at step start, shared by the enemy AI and attack checks.
        rel_all = state.unit_pos[:, None, :] - state.unit_pos[None, :, :]  # (N, N, 2)
        dist_all = jnp.linalg.norm(rel_all, axis=-1)

        enemy_action = self._enemy_actions(
            state, enemy_key, -rel_all[a:, :a], dist_all[a:, :a]
        )
        # Enemy attack targets index into the ALLY team.
        all_actions = jnp.concatenate([action.astype(jnp.int32), enemy_action])

        alive = state.unit_hp > 0
        stats = self._unit_stats(state)
        speed = stats[:, 4]
        atk_range = stats[:, 2]
        dps = stats[:, 1]

        is_move = (all_actions >= 1) & (all_actions <= 4)
        move_dir = self._move_dirs[jnp.clip(all_actions - 1, 0, 3)]
        new_pos = state.unit_pos + move_dir * (speed * _STEP_SCALE)[:, None] * (
            is_move & alive
        )[:, None].astype(jnp.float32)
        new_pos = jnp.clip(
            new_pos,
            jnp.array([0.5, 0.5]),
            jnp.array([MAP_WIDTH - 0.5, MAP_HEIGHT - 0.5]),
        )

        # --- attacks (positions at step start, SMAC-style attack-replaces-move) ----
        is_attack = all_actions >= 5
        # Target as a global unit index: allies target enemy (a + i), enemies target i.
        raw_target = jnp.clip(all_actions - 5, 0, jnp.maximum(e, a) - 1)
        target = jnp.where(
            jnp.arange(n) < a,
            jnp.clip(raw_target, 0, e - 1) + a,
            jnp.clip(raw_target, 0, a - 1),
        )
        tgt_dist = jnp.take_along_axis(dist_all, target[:, None], axis=1)[:, 0]
        valid_attack = (
            is_attack & alive & alive[target] & (tgt_dist <= atk_range)
        )
        # Damage accumulation as an (N, N) one-hot reduction instead of a scatter-add
        # (fuses elementwise; the scatter alternative is a ROADMAP S5 A/B).
        damage_out = jnp.where(valid_attack, dps, 0.0)
        hits = (target[:, None] == jnp.arange(n)[None, :]) & valid_attack[:, None]
        damage_in = jnp.sum(hits * damage_out[:, None], axis=0)
        new_hp = jnp.clip(state.unit_hp - damage_in, 0.0, None)
        newly_dead = (state.unit_hp > 0) & (new_hp <= 0)

        # --- rewards (ally perspective) --------------------------------------------
        enemy_damage_taken = jnp.sum(
            jnp.minimum(damage_in[a:], state.unit_hp[a:])
        )
        enemy_kills = jnp.sum(newly_dead[a:]).astype(jnp.float32)
        all_enemies_dead = jnp.all(new_hp[a:] <= 0)
        all_allies_dead = jnp.all(new_hp[:a] <= 0)
        win_bonus = jnp.where(all_enemies_dead, 200.0, 0.0)
        team_reward = (
            (enemy_damage_taken + 10.0 * enemy_kills + win_bonus)
            / state.max_reward
            * 20.0
        )
        reward = jnp.repeat(team_reward.astype(jnp.float32), a)

        step_count = state.step_count + 1
        new_state = SmaxState(
            key=key,
            step_count=step_count,
            unit_pos=new_pos,
            unit_hp=new_hp,
            unit_types=state.unit_types,
            max_reward=state.max_reward,
        )
        obs = self._observe(new_state)
        extras = {"won_episode": all_enemies_dead}

        # One fused timestep build: wipe-out -> termination (discount 0),
        # time_up -> truncation (discount 1) — no lax.cond over the obs pytree.
        wiped = all_enemies_dead | all_allies_dead
        time_up = step_count >= self.time_limit
        done = wiped | time_up
        timestep = TimeStep(
            step_type=jnp.where(
                done, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(wiped, 0.0, 1.0)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras=extras,
        )
        return new_state, timestep

    # ------------------------------------------------------------------ global state
    def get_global_state(self, obs: Observation, state: SmaxState) -> jnp.ndarray:
        """SMAX 'world state': every unit's features, identical for all agents."""
        flat = self._unit_feats(state).reshape(-1)
        return jnp.tile(flat, (self.num_agents, 1))

    def global_state_spec(self) -> specs.Array:
        return specs.Array(
            (self.num_agents, self.global_state_features), jnp.float32, "global_state"
        )

    # ------------------------------------------------------------------ specs
    def observation_spec(self) -> specs.TreeSpec:
        return specs.TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=specs.Array(
                (self.num_agents, self.num_obs_features), jnp.float32, "agents_view"
            ),
            action_mask=specs.Array(
                (self.num_agents, self.action_dim), jnp.bool_, "action_mask"
            ),
            step_count=specs.BoundedArray(
                (self.num_agents,),
                jnp.int32,
                "step_count",
                minimum=0,
                maximum=self.time_limit,
            ),
        )

    def action_spec(self) -> specs.DiscreteArray:
        return specs.DiscreteArray(
            (self.num_agents,), jnp.int32, "action", num_values=self.action_dim
        )

    def reward_spec(self) -> specs.Array:
        return specs.Array((self.num_agents,), jnp.float32, "reward")

    @property
    def unwrapped(self) -> "Smax":
        return self
