"""MaCheetah: multi-agent half-cheetah — contact locomotion on a kinematic TREE.

The canonical MaBrax benchmark is `halfcheetah_6x1` (reference
`mava/wrappers/jaxmarl.py:376-405`, `configs/env/scenario/...`): a planar torso
with BACK and FRONT leg chains — a kinematic tree, not the serial chain that
MaReacher/MaSwimmer/MaHopper use. Six joints (back/front thigh, shin, foot),
factorized one per agent.

Tree kinematics, vectorised: the topology is static, so the path structure is
baked into two constant matrices at construction —

    phi    = th + C @ (alpha + rest)      C[k, j] = joint j on the root->link-k path
    start  = base + S @ (L * u)           S[k, m] = fraction of link m traversed
                                                    reaching link k's anchor
    ends   = start + L * u

— and the whole forward kinematics is two small dense matmuls (no gather, no
scatter, no per-link loop at trace time). Everything downstream is the same
autodiff-Lagrangian machinery as `mahopper.py`: mass matrix via `jax.hessian`
of the kinetic energy, Coriolis via `jacfwd`, gravity from a potential, and
compliant ground contact (spring-damper normal + Coulomb-clamped friction)
applied through `jax.vjp` of the contact kinematics.

Task (MuJoCo HalfCheetah-v4 semantics): shared team reward = forward
center-of-mass velocity - 0.1 * control cost; episodes only truncate (the
half-cheetah has no unhealthy termination — it can keep running even pitched
over), in contrast to MaHopper's failure-state termination.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_TORQUE_SCALE = 15.0
_MAX_SPEED = 50.0
_CTRL_COST = 0.1
_ARMATURE = 0.1
_JOINT_DAMPING = 0.5
_CONTACT_KP = 8000.0
_CONTACT_KD = 150.0
_CONTACT_KT = 300.0
_FRICTION_MU = 0.9
_STAND_CLEARANCE = 0.005
# MuJoCo-style limited joints: a stiff spring-damper beyond the range keeps the
# legs from folding flat under gravity (the body can brace on its limits, like
# the real half-cheetah's `range=` joint attributes).
_LIMIT_KP = 200.0
_LIMIT_KD = 5.0
_JOINT_LO = (-0.5, -0.8, -0.5, -1.0, -1.0, -0.5)
_JOINT_HI = (1.0, 0.8, 0.8, 0.7, 0.9, 0.5)

# link: (name, parent index, anchor fraction on parent, length, rest angle offset)
# Root torso lies along +x; legs hang below, knees bent opposite ways like the
# MuJoCo half-cheetah. Joint order (= agent order): bthigh bshin bfoot fthigh
# fshin ffoot.
_TOPOLOGY = (
    ("torso", -1, 0.0, 1.00, 0.0),
    ("bthigh", 0, 0.0, 0.30, -1.90),  # hangs down-back from the torso back end
    ("bshin", 1, 1.0, 0.30, 0.70),  # knee bends forward
    ("bfoot", 2, 1.0, 0.20, 0.50),
    ("fthigh", 0, 1.0, 0.30, -1.20),  # hangs down-front from the torso front end
    ("fshin", 4, 1.0, 0.30, -0.60),  # knee bends backward
    ("ffoot", 5, 1.0, 0.20, 0.60),
)


@struct.dataclass
class MaCheetahState:
    key: PRNGKey
    step_count: jnp.ndarray
    q: jnp.ndarray  # (3 + J,) = (x, y, th, joint angles), base at the torso back end
    qd: jnp.ndarray  # (3 + J,)


class MaCheetah:
    """Planar half-cheetah (torso + 2 three-link legs), joints across agents.

    The topology/limits/reward constants are class attributes so sibling
    planar-tree robots (MaWalker) can subclass with a different body.
    """

    TOPOLOGY = _TOPOLOGY
    JOINT_LO = _JOINT_LO
    JOINT_HI = _JOINT_HI
    DEFAULT_TORQUE = _TORQUE_SCALE
    CTRL_COST = _CTRL_COST
    HEALTHY_BONUS = 0.0  # half-cheetah has no alive bonus (and no termination)
    TORSO_REST = 0.0  # torso lies along +x

    def __init__(
        self,
        num_agents: int = 6,
        joints_per_agent: int = 1,
        time_limit: int = 250,
        torque_scale: float | None = None,
        joint_damping: float = _JOINT_DAMPING,
        gravity: float = _GRAVITY,
    ):
        _TOPOLOGY = self.TOPOLOGY
        num_joints = num_agents * joints_per_agent
        assert num_joints == len(_TOPOLOGY) - 1, (
            f"{type(self).__name__} has exactly {len(_TOPOLOGY) - 1} joints; "
            "choose a factorization with num_agents*joints_per_agent == "
            f"{len(_TOPOLOGY) - 1}, got {num_joints}"
        )
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_joints
        self.num_links = len(_TOPOLOGY)
        self.time_limit = time_limit
        self.torque_scale = float(
            self.DEFAULT_TORQUE if torque_scale is None else torque_scale
        )
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.action_dim = joints_per_agent

        L = self.num_links
        parents = [t[1] for t in _TOPOLOGY]
        fracs = [t[2] for t in _TOPOLOGY]
        self.link_lengths = jnp.array([t[3] for t in _TOPOLOGY])
        self._rest_offsets = jnp.array([t[4] for t in _TOPOLOGY][1:])
        self.masses = self.link_lengths  # uniform density 1
        self.inertias = self.masses * self.link_lengths**2 / 12.0

        # Path matrices (constants; numpy at construction, never traced).
        C = np.zeros((L, L - 1))  # joint j belongs to link j+1
        S = np.zeros((L, L))  # start[k] = base + S @ (L * u)
        for k in range(1, L):
            p = parents[k]
            C[k] = C[p]
            C[k, k - 1] = 1.0
            S[k] = S[p]
            S[k, p] += fracs[k]
        self._C = jnp.array(C)
        self._S = jnp.array(S)
        self._joint_lo = jnp.array(self.JOINT_LO)
        self._joint_hi = jnp.array(self.JOINT_HI)

        # own joints (cos, sin, vel) + shared (torso_y, cos th, sin th, thd, vx, vy)
        self.num_obs_features = 3 * joints_per_agent + 6

    # ------------------------------------------------------------- kinematics
    def _frames(self, q: jnp.ndarray):
        """((L,2) starts, (L,2) steps, (L,) absolute angles)."""
        base, th, alpha = q[:2], q[2], q[3:]
        phi = th + self._C @ (alpha + self._rest_offsets)
        u = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)
        steps = self.link_lengths[:, None] * u
        starts = base[None, :] + self._S @ steps
        return starts, steps, phi

    def _body_frame(self, q: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        starts, steps, phi = self._frames(q)
        return starts + 0.5 * steps, phi

    def _contact_points(self, q: jnp.ndarray) -> jnp.ndarray:
        """(L+1, 2): the base plus every link far end."""
        starts, steps, _ = self._frames(q)
        return jnp.concatenate([q[None, :2], starts + steps], axis=0)

    def _com(self, q: jnp.ndarray) -> jnp.ndarray:
        centers, _ = self._body_frame(q)
        return jnp.sum(self.masses[:, None] * centers, axis=0) / jnp.sum(self.masses)

    # --------------------------------------------------------------- dynamics
    def _velocities(self, q, qd):
        return jax.jvp(self._body_frame, (q,), (qd,))[1]

    def _kinetic(self, q: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
        vel, omega = self._velocities(q, qd)
        return (
            0.5 * jnp.sum(self.masses[:, None] * vel**2)
            + 0.5 * jnp.sum(self.inertias * omega**2)
            + 0.5 * _ARMATURE * jnp.sum(qd[3:] ** 2)
        )

    def _potential(self, q: jnp.ndarray) -> jnp.ndarray:
        centers, _ = self._body_frame(q)
        return self.gravity * jnp.sum(self.masses * centers[:, 1])

    def _contact_force(self, q: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
        pts, pts_dot = jax.jvp(self._contact_points, (q,), (qd,))
        depth = -pts[:, 1]
        f_n = jnp.where(
            depth > 0.0, _CONTACT_KP * depth - _CONTACT_KD * pts_dot[:, 1], 0.0
        )
        f_n = jnp.maximum(f_n, 0.0)
        f_t = jnp.clip(
            -_CONTACT_KT * pts_dot[:, 0], -_FRICTION_MU * f_n, _FRICTION_MU * f_n
        )
        forces = jnp.stack([f_t, f_n], axis=-1)
        _, vjp = jax.vjp(self._contact_points, q)
        return vjp(forces)[0]

    def mass_matrix(self, q: jnp.ndarray) -> jnp.ndarray:
        return jax.hessian(self._kinetic, argnums=1)(q, jnp.zeros_like(q))

    def _accel(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
        M = self.mass_matrix(q)
        momentum = lambda q_: jax.grad(self._kinetic, argnums=1)(q_, qd)
        coriolis = jax.jacfwd(momentum)(q) @ qd
        dT_dq = jax.grad(self._kinetic, argnums=0)(q, qd)
        dV_dq = jax.grad(self._potential)(q)
        damping = -self.joint_damping * jnp.concatenate([jnp.zeros(3), qd[3:]])
        alpha, alpha_d = q[3:], qd[3:]
        excess = jnp.maximum(alpha - self._joint_hi, 0.0) + jnp.minimum(
            alpha - self._joint_lo, 0.0
        )
        limit_tau = -_LIMIT_KP * excess - _LIMIT_KD * alpha_d * (excess != 0.0)
        limits = jnp.concatenate([jnp.zeros(3), limit_tau])
        rhs = (
            tau + self._contact_force(q, qd) + damping + limits
            - coriolis + dT_dq - dV_dq
        )
        return jnp.linalg.solve(M, rhs)

    def _integrate(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray):
        h = _DT / _SUBSTEPS

        def deriv(state):
            q, qd = state
            return qd, self._accel(q, qd, tau)

        def sub(carry, _):
            q, qd = carry
            k1 = deriv((q, qd))
            k2 = deriv((q + 0.5 * h * k1[0], qd + 0.5 * h * k1[1]))
            k3 = deriv((q + 0.5 * h * k2[0], qd + 0.5 * h * k2[1]))
            k4 = deriv((q + h * k3[0], qd + h * k3[1]))
            q = q + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            qd = qd + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
            qd = jnp.clip(qd, -_MAX_SPEED, _MAX_SPEED)
            return (q, qd), None

        (q, qd), _ = jax.lax.scan(sub, (q, qd), None, _SUBSTEPS)
        angles = jnp.mod(q[3:] + jnp.pi, 2 * jnp.pi) - jnp.pi
        q = jnp.concatenate([q[:3], angles])
        return q, qd

    # -------------------------------------------------------------------- API
    def _observe(self, state: MaCheetahState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        alpha = state.q[3:].reshape(a, jpa)
        alpha_d = state.qd[3:].reshape(a, jpa)
        torso_y = self._body_frame(state.q)[0][0, 1]
        shared = jnp.array(
            [
                torso_y,
                jnp.cos(state.q[2]),
                jnp.sin(state.q[2]),
                state.qd[2] / 10.0,
                state.qd[0] / 10.0,
                state.qd[1] / 10.0,
            ]
        )
        agents_view = jnp.concatenate(
            [
                jnp.cos(alpha),
                jnp.sin(alpha),
                alpha_d / 10.0,
                jnp.broadcast_to(shared, (a, 6)),
            ],
            axis=-1,
        ).astype(jnp.float32)
        mask = jnp.ones((a, self.action_dim), dtype=jnp.bool_)
        return Observation(agents_view, mask, jnp.repeat(state.step_count, a))

    def _terminated(self, q: jnp.ndarray) -> jnp.ndarray:
        """Failure-state check; the half-cheetah never terminates (it can keep
        running pitched over), MaWalker overrides with a healthy-state test."""
        return jnp.bool_(False)

    def reset(self, key: PRNGKey) -> Tuple[MaCheetahState, TimeStep]:
        key, q_key = jax.random.split(key)
        noise = jax.random.uniform(
            q_key, (1 + self.num_joints,), minval=-0.05, maxval=0.05
        )
        rest = jnp.concatenate(
            [jnp.zeros(2), jnp.full((1,), self.TORSO_REST), jnp.zeros(self.num_joints)]
        )
        q = rest + jnp.concatenate([jnp.zeros(2), noise])
        # Drop the base so the lowest contact point starts at the clearance.
        lowest = jnp.min(self._contact_points(q)[:, 1])
        q = q.at[1].add(_STAND_CLEARANCE - lowest)
        state = MaCheetahState(
            key=key,
            step_count=jnp.int32(0),
            q=q,
            qd=jnp.zeros(3 + self.num_joints),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: MaCheetahState, action: jnp.ndarray
    ) -> Tuple[MaCheetahState, TimeStep]:
        action = jnp.clip(action, -1.0, 1.0)  # (A, jpa)
        tau = jnp.concatenate(
            [jnp.zeros(3), action.reshape(self.num_joints) * self.torque_scale]
        )
        com_before = self._com(state.q)
        q, qd = self._integrate(state.q, state.qd, tau)

        step_count = state.step_count + 1
        new_state = MaCheetahState(key=state.key, step_count=step_count, q=q, qd=qd)

        forward = (self._com(q)[0] - com_before[0]) / _DT
        ctrl = self.CTRL_COST * jnp.sum(action**2)
        reward = jnp.repeat(
            (forward + self.HEALTHY_BONUS - ctrl).astype(jnp.float32), self.num_agents
        )

        terminated = self._terminated(q)
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=jnp.where(
                terminated | time_up, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            # discount 0 only on real termination; truncation bootstraps.
            discount=jnp.where(terminated, 0.0, 1.0).astype(jnp.float32)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=self._observe(new_state),
            extras={},
        )
        return new_state, timestep

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

    def action_spec(self) -> specs.BoundedArray:
        return specs.BoundedArray(
            (self.num_agents, self.action_dim),
            jnp.float32,
            "action",
            minimum=-1.0,
            maximum=1.0,
        )

    def reward_spec(self) -> specs.Array:
        return specs.Array((self.num_agents,), jnp.float32, "reward")

    @property
    def unwrapped(self) -> "MaCheetah":
        return self
