"""RobotWarehouse (RWARE), implemented natively in JAX.

The reference wraps Jumanji's RobotWarehouse (`mava/wrappers/jumanji.py:128-155`); that
dependency does not exist in this image, so the environment itself is reimplemented here
from the published RWARE rules, with the Jumanji variant's semantics:

  * grid layout parameterised by (shelf_rows, shelf_columns, column_height), goals at the
    bottom-centre, highway aisles between shelf blocks;
  * actions per agent: 0=noop, 1=forward, 2=turn-left, 3=turn-right, 4=toggle-load;
  * a request queue of `request_queue_size` shelves; delivering a requested shelf to a
    goal yields +1 team reward and a new (distinct) shelf is requested;
  * agents carrying a shelf cannot move through occupied storage cells; unloaded agents
    can pass under shelves;
  * **episodes terminate on agent collision** (two agents in the same cell after a step,
    or a pass-through swap) — the harder Jumanji variant (see reference
    `docs/jumanji_rware_comparison.md`);
  * observation per agent: own (y, x, carrying) plus a (2r+1)^2 window with 7 features
    per cell [agent present, direction one-hot(4), shelf present, shelf requested] —
    66 features at sensor_range=1, float32;
  * rewards/discounts are already per-agent (the repetition the reference applies in
    `RwareWrapper.modify_timestep`, `mava/wrappers/jumanji.py:135-144`).

Everything is static-shape and vmap/scan-friendly. The step avoids scatters in
the hot path — occupancy grids and lookups are built from iota comparisons and
tiny einsums, which fuse into elementwise kernels (hypothesis to A/B on the GPU
against batched scatters, ROADMAP S5) — the per-agent delivery loop is unrolled
at trace time, and the terminal/truncation branches collapse into one fused
timestep build instead of a 3-way `lax.cond` over the whole observation pytree.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

# Direction encoding: 0=up, 1=right, 2=down, 3=left (clockwise).
_DIR_VECS = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int32)

NOOP, FORWARD, LEFT, RIGHT, TOGGLE = 0, 1, 2, 3, 4
NUM_ACTIONS = 5


@struct.dataclass
class RwareState:
    key: PRNGKey
    step_count: jnp.ndarray  # () int32
    agent_pos: jnp.ndarray  # (A, 2) int32
    agent_dir: jnp.ndarray  # (A,) int32
    agent_carrying: jnp.ndarray  # (A,) int32, shelf id or -1
    shelf_pos: jnp.ndarray  # (S, 2) int32
    shelf_requested: jnp.ndarray  # (S,) bool


def _build_layout(
    shelf_rows: int, shelf_columns: int, column_height: int
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Returns (storage_mask (H,W), goals (2,2) as (row, col), (H, W))."""
    height = (column_height + 1) * shelf_rows + 2
    width = 3 * shelf_columns + 1
    goals = np.array(
        [[height - 1, width // 2 - 1], [height - 1, width // 2]], dtype=np.int32
    )

    ys, xs = np.mgrid[0:height, 0:width]
    highway = (
        (xs % 3 == 0)
        | (ys % (column_height + 1) == 0)
        | (ys == height - 1)
        | (
            (ys > height - (column_height + 3))
            & ((xs == goals[0, 1]) | (xs == goals[1, 1]))
        )
    )
    storage_mask = ~highway
    return storage_mask, goals, (height, width)


class RobotWarehouse:
    """RWARE in JAX. All methods are pure and jittable."""

    def __init__(
        self,
        shelf_rows: int = 1,
        shelf_columns: int = 3,
        column_height: int = 8,
        num_agents: int = 2,
        sensor_range: int = 1,
        request_queue_size: int = 2,
        time_limit: int = 500,
    ):
        storage_mask, goals, (height, width) = _build_layout(
            shelf_rows, shelf_columns, column_height
        )
        self.height, self.width = height, width
        self.num_agents = num_agents
        self.sensor_range = sensor_range
        self.request_queue_size = request_queue_size
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS

        self._storage_mask = jnp.asarray(storage_mask)
        self._goals = jnp.asarray(goals)
        # Initial shelf positions: every storage cell holds a shelf.
        shelf_cells = np.argwhere(storage_mask).astype(np.int32)
        self.num_shelves = int(shelf_cells.shape[0])
        self._init_shelf_pos = jnp.asarray(shelf_cells)

        self._goal_flat = jnp.asarray(goals[:, 0] * width + goals[:, 1])
        self._storage_flat = jnp.asarray(storage_mask.reshape(-1))
        self._shelf_iota = jnp.arange(self.num_shelves, dtype=jnp.int32)

        window = 2 * sensor_range + 1
        # Sensor-window cell offsets, row-major (dy outer, dx inner) so the flattened
        # per-cell features match a (window, window, 7) crop's reshape(-1).
        dys, dxs = np.mgrid[-sensor_range : sensor_range + 1,
                            -sensor_range : sensor_range + 1]
        self._window_offsets = jnp.asarray(
            np.stack([dys.ravel(), dxs.ravel()], axis=-1).astype(np.int32)
        )  # (window*window, 2)
        self.num_obs_features = 3 + window * window * 7

    # ------------------------------------------------------------------ helpers
    def _flat(self, pos: jnp.ndarray) -> jnp.ndarray:
        """(N, 2) (row, col) -> (N,) flat cell index."""
        return pos[:, 0] * self.width + pos[:, 1]

    def _shelf_id_at(
        self, flat_shelf: jnp.ndarray, flat_query: jnp.ndarray
    ) -> jnp.ndarray:
        """Shelf id + 1 at each queried cell (0 = empty). (Q, S) iota compare —
        no grid build, no scatter/gather."""
        hit = flat_query[:, None] == flat_shelf[None, :]
        return jnp.sum(hit * (self._shelf_iota[None, :] + 1), axis=-1)

    def _observe(self, state: RwareState) -> Observation:
        a = self.num_agents

        flat_shelf = self._flat(state.shelf_pos)
        flat_agent = self._flat(state.agent_pos)

        # Sensor windows without materialising any (H, W) grid: each window cell's
        # features [agent, dir(4 one-hot), shelf, requested] come straight from
        # (A·window², A) / (A·window², S) iota compares + one tiny einsum. No
        # scatters, no pad, no batched gather — everything fuses elementwise.
        qpos = state.agent_pos[:, None, :] + self._window_offsets[None]  # (A, K, 2)
        valid = (
            (qpos[..., 0] >= 0)
            & (qpos[..., 0] < self.height)
            & (qpos[..., 1] >= 0)
            & (qpos[..., 1] < self.width)
        )  # (A, K)
        flat_q = jnp.where(valid, qpos[..., 0] * self.width + qpos[..., 1], -1)

        eq_agent = flat_q[..., None] == flat_agent[None, None, :]  # (A, K, A)
        eq_shelf = flat_q[..., None] == flat_shelf[None, None, :]  # (A, K, S)
        dir_onehot = jax.nn.one_hot(state.agent_dir, 4, dtype=jnp.float32)  # (A, 4)

        agent_f = jnp.any(eq_agent, axis=-1)  # (A, K)
        dir_f = jnp.einsum(
            "qka,ad->qkd", eq_agent.astype(jnp.float32), dir_onehot
        )  # (A, K, 4)
        shelf_f = jnp.any(eq_shelf, axis=-1)  # (A, K)
        req_f = jnp.einsum(
            "qks,s->qk",
            eq_shelf.astype(jnp.float32),
            state.shelf_requested.astype(jnp.float32),
        )  # (A, K)

        cell_features = jnp.concatenate(
            [
                agent_f[..., None].astype(jnp.float32),
                dir_f,
                shelf_f[..., None].astype(jnp.float32),
                req_f[..., None],
            ],
            axis=-1,
        )  # (A, K, 7)
        windows = cell_features.reshape(a, -1)  # (A, window*window*7)

        own = jnp.concatenate(
            [
                state.agent_pos.astype(jnp.float32),
                (state.agent_carrying >= 0).astype(jnp.float32)[:, None],
            ],
            axis=-1,
        )  # (A, 3)
        agents_view = jnp.concatenate([own, windows], axis=-1)

        action_mask = self._action_mask(state, flat_shelf)
        step_count = jnp.repeat(state.step_count, a)
        return Observation(agents_view, action_mask, step_count)

    def _action_mask(
        self, state: RwareState, flat_shelf: jnp.ndarray
    ) -> jnp.ndarray:
        target = state.agent_pos + _DIR_VECS_J[state.agent_dir]
        in_bounds = (
            (target[:, 0] >= 0)
            & (target[:, 0] < self.height)
            & (target[:, 1] >= 0)
            & (target[:, 1] < self.width)
        )
        safe_target = jnp.clip(
            target,
            0,
            jnp.array([self.height - 1, self.width - 1], dtype=jnp.int32),
        )
        shelf_at_target = self._shelf_id_at(flat_shelf, self._flat(safe_target)) > 0
        carrying = state.agent_carrying >= 0
        fwd_ok = in_bounds & ~(carrying & shelf_at_target)

        flat_here = self._flat(state.agent_pos)
        shelf_here = self._shelf_id_at(flat_shelf, flat_here) > 0
        on_storage = self._storage_flat[flat_here]
        toggle_ok = jnp.where(carrying, on_storage, shelf_here)

        ones = jnp.ones_like(fwd_ok)
        return jnp.stack([ones, fwd_ok, ones, ones, toggle_ok], axis=-1)

    # ------------------------------------------------------------------ API
    def reset(self, key: PRNGKey) -> Tuple[RwareState, TimeStep]:
        key, pos_key, dir_key, req_key = jax.random.split(key, 4)

        # Distinct uniform samples via top-k over iid uniforms (a uniform random
        # k-subset) — far cheaper than random.choice(replace=False)'s full argsort,
        # and this runs every step inside the vmapped AutoReset select.
        n_cells = self.height * self.width
        _, cells = jax.lax.top_k(
            jax.random.uniform(pos_key, (n_cells,)), self.num_agents
        )
        agent_pos = jnp.stack([cells // self.width, cells % self.width], axis=-1)
        agent_pos = agent_pos.astype(jnp.int32)
        agent_dir = jax.random.randint(dir_key, (self.num_agents,), 0, 4)

        # Build the request mask from top_k's INDICES (compare-based, scatter-free)
        # so exactly request_queue_size shelves are requested regardless of ties —
        # the old score-threshold compare silently relied on two uniform() calls
        # being bit-identical (ADVICE r1).
        _, req_idx = jax.lax.top_k(
            jax.random.uniform(req_key, (self.num_shelves,)),
            self.request_queue_size,
        )
        shelf_requested = jnp.any(
            req_idx[:, None] == jnp.arange(self.num_shelves)[None, :], axis=0
        )

        state = RwareState(
            key=key,
            step_count=jnp.int32(0),
            agent_pos=agent_pos,
            agent_dir=agent_dir.astype(jnp.int32),
            agent_carrying=jnp.full(self.num_agents, -1, dtype=jnp.int32),
            shelf_pos=self._init_shelf_pos,
            shelf_requested=shelf_requested,
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: RwareState, action: jnp.ndarray
    ) -> Tuple[RwareState, TimeStep]:
        action = action.astype(jnp.int32)
        flat_shelf_pre = self._flat(state.shelf_pos)
        carrying = state.agent_carrying >= 0

        # --- movement ---------------------------------------------------------
        fwd = state.agent_pos + _DIR_VECS_J[state.agent_dir]
        in_bounds = (
            (fwd[:, 0] >= 0)
            & (fwd[:, 0] < self.height)
            & (fwd[:, 1] >= 0)
            & (fwd[:, 1] < self.width)
        )
        safe_fwd = jnp.clip(
            fwd, 0, jnp.array([self.height - 1, self.width - 1], dtype=jnp.int32)
        )
        shelf_at_fwd = self._shelf_id_at(flat_shelf_pre, self._flat(safe_fwd)) > 0
        can_move = in_bounds & ~(carrying & shelf_at_fwd)
        moves = (action == FORWARD) & can_move
        new_pos = jnp.where(moves[:, None], safe_fwd, state.agent_pos)

        new_dir = state.agent_dir
        new_dir = jnp.where(action == LEFT, (new_dir - 1) % 4, new_dir)
        new_dir = jnp.where(action == RIGHT, (new_dir + 1) % 4, new_dir)

        # --- collision detection (episode terminates) --------------------------
        flat_new = self._flat(new_pos)
        same_cell = (flat_new[:, None] == flat_new[None, :]) & ~jnp.eye(
            self.num_agents, dtype=jnp.bool_
        )
        flat_old = self._flat(state.agent_pos)
        swap = (
            (flat_new[:, None] == flat_old[None, :])
            & (flat_old[:, None] == flat_new[None, :])
            & ~jnp.eye(self.num_agents, dtype=jnp.bool_)
        )
        collision = jnp.any(same_cell) | jnp.any(swap)

        # Carried shelves travel with their agent — (S, A) compare-select instead of a
        # scatter into the shelf table.
        move_mat = (
            state.agent_carrying[None, :] == self._shelf_iota[:, None]
        ) & (carrying & moves)[None, :]  # (S, A)
        moved = jnp.any(move_mat, axis=-1)
        dest = jnp.einsum("sa,ac->sc", move_mat.astype(jnp.int32), new_pos)
        shelf_pos = jnp.where(moved[:, None], dest, state.shelf_pos)

        # --- toggle load/unload -------------------------------------------------
        flat_shelf = self._flat(shelf_pos)
        shelf_here = self._shelf_id_at(flat_shelf, flat_new)  # id+1 or 0
        on_storage = self._storage_flat[flat_new]
        toggles = action == TOGGLE

        pickup = toggles & ~carrying & (shelf_here > 0)
        drop = toggles & carrying & on_storage
        new_carrying = jnp.where(pickup, shelf_here - 1, state.agent_carrying)
        new_carrying = jnp.where(drop, -1, new_carrying)

        # --- deliveries (sequential over agents for distinct new requests;
        # unrolled at trace time — num_agents is static) ------------------------
        at_goal = jnp.any(flat_new[:, None] == self._goal_flat[None, :], axis=-1)
        key = state.key
        requested = state.shelf_requested
        team_reward = jnp.float32(0.0)
        for i in range(self.num_agents):
            key, sub = jax.random.split(key)
            sid = jnp.clip(new_carrying[i], 0, self.num_shelves - 1)
            sid_onehot = self._shelf_iota == sid
            do = (
                (new_carrying[i] >= 0)
                & jnp.any(requested & sid_onehot)
                & at_goal[i]
            )
            # New request: uniform over currently-unrequested shelves (the delivered
            # shelf is still marked requested here, so it is excluded).
            logits = jnp.where(~requested, 0.0, -jnp.inf)
            new_req = jax.random.categorical(sub, logits)
            updated = jnp.where(self._shelf_iota == new_req, True, requested)
            updated = jnp.where(sid_onehot, False, updated)
            requested = jnp.where(do, updated, requested)
            team_reward = team_reward + do.astype(jnp.float32)

        # --- bookkeeping: one fused timestep build (no lax.cond over the obs) ---
        step_count = state.step_count + 1
        new_state = RwareState(
            key=key,
            step_count=step_count,
            agent_pos=new_pos,
            agent_dir=new_dir,
            agent_carrying=new_carrying,
            shelf_pos=shelf_pos,
            shelf_requested=requested,
        )
        obs = self._observe(new_state)
        reward = jnp.repeat(team_reward, self.num_agents)

        time_up = step_count >= self.time_limit
        done = collision | time_up
        # collision -> termination (discount 0); time_up -> truncation (discount 1).
        timestep = TimeStep(
            step_type=jnp.where(
                done, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(collision, 0.0, 1.0)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
            extras={},
        )
        return new_state, timestep

    # ------------------------------------------------------------------ specs
    def observation_spec(self) -> specs.TreeSpec:
        return specs.TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=specs.Array(
                (self.num_agents, self.num_obs_features), jnp.float32, "agents_view"
            ),
            action_mask=specs.Array(
                (self.num_agents, NUM_ACTIONS), jnp.bool_, "action_mask"
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
            (self.num_agents,), jnp.int32, "action", num_values=NUM_ACTIONS
        )

    def reward_spec(self) -> specs.Array:
        return specs.Array((self.num_agents,), jnp.float32, "reward")

    @property
    def unwrapped(self) -> "RobotWarehouse":
        return self


_DIR_VECS_J = jnp.asarray(_DIR_VECS)
