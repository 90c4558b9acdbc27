"""MaHopper: multi-agent hopper locomotion — articulated CONTACT dynamics.

Completes the MaBrax-class continuous-control family (reference
`mava/wrappers/jaxmarl.py:376-405`, `configs/env/mabrax.yaml`) with the piece
MaReacher (fixed-base manipulation) and MaSwimmer (free-floating viscous
locomotion) don't exercise: **gravity, ground contact, and failure-state
termination** — the defining features of the MuJoCo hopper/walker benchmarks.
Joints are factorized across agents exactly like MaBrax (`hopper_3x1` =
3 agents x 1 joint each: hip, knee, ankle).

The body is a planar serial chain (torso -> thigh -> leg -> foot) with a free
(x, y, th) base at the torso tip, using the same autodiff-Lagrangian idiom as
`maswimmer.py` (kinetic energy written down, mass matrix = `jax.hessian`,
Coriolis via `jacfwd` of the momentum — no hand-rolled Newton-Euler, no
scatters; everything vmaps into small batched matmuls/solves):

    q        = (x, y, th, a_hip, a_knee, a_ankle)
    M qdd    = tau + Q_contact - dR/dqd - C(q,qd) qd + dT/dq - dV/dq
    V(q)     = g * sum_k m_k y_ck                    (gravity potential)
    R(q,qd)  = 1/2 c_j sum qd_joint^2                (rotor damping)

Ground contact is a compliant penalty model at every link endpoint (the
standard differentiable-simulation formulation, cf. Brax's spring-damper
contact): for a point at depth d below ground with velocity v,

    F_n = max(0, kp*d - kd*v_y)          (spring-damper, no adhesion)
    F_t = clip(-kt*v_x, -mu*F_n, mu*F_n) (viscous friction, Coulomb-clamped)

mapped to generalized coordinates through the contact-point Jacobian
transpose — computed by `jax.vjp` of the forward kinematics, so the dynamics
stay scatter-free and exactly consistent with the kinematics.

Task (MuJoCo Hopper-v4 semantics): shared team reward = forward velocity
+ healthy bonus - control cost; the episode TERMINATES (discount 0) when the
torso drops below `min_torso_height` or pitches beyond `max_pitch` — giving
the off-policy systems a real termination/bootstrap distinction to handle,
which the swimmer/reacher tasks (truncation-only) never produce.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_TORQUE_SCALE = 30.0
_MAX_SPEED = 50.0  # safety clip far outside normal play
_CTRL_COST = 1e-3
_HEALTHY_BONUS = 1.0
# Rotor (armature) inertia + viscous damping at each actuated joint — the same
# stiffness-bounding rationale as maswimmer.py:_ARMATURE/_JOINT_DAMPING.
_ARMATURE = 0.1
_JOINT_DAMPING = 0.5
# Compliant contact. Static penetration ~ m g / kp ~ 5 mm on a 1.45 m body;
# contact eigenfrequency sqrt(kp/m_link) ~ 90/s, vs RK4 substep h = 2 ms
# (h*omega ~ 0.18, comfortably inside the stability region).
_CONTACT_KP = 8000.0
_CONTACT_KD = 150.0
_CONTACT_KT = 300.0
_FRICTION_MU = 0.9

# torso, thigh, leg, foot
_LINK_LENGTHS = (0.5, 0.45, 0.5, 0.35)
_STAND_CLEARANCE = 0.005  # initial heel height above ground


@struct.dataclass
class MaHopperState:
    key: PRNGKey
    step_count: jnp.ndarray
    q: jnp.ndarray  # (3 + J,) = (x, y, th, joint angles), base at the torso tip
    qd: jnp.ndarray  # (3 + J,)


class MaHopper:
    """Planar hopper (torso/thigh/leg/foot chain), joints factorized across agents."""

    def __init__(
        self,
        num_agents: int = 3,
        joints_per_agent: int = 1,
        time_limit: int = 250,
        torque_scale: float = _TORQUE_SCALE,
        joint_damping: float = _JOINT_DAMPING,
        gravity: float = _GRAVITY,
        min_torso_height: float = 0.7,
        max_pitch: float = 0.4,
    ):
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_agents * joints_per_agent
        self.num_links = self.num_joints + 1
        self.time_limit = time_limit
        self.torque_scale = float(torque_scale)
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.min_torso_height = float(min_torso_height)
        self.max_pitch = float(max_pitch)
        self.action_dim = joints_per_agent

        if self.num_links == len(_LINK_LENGTHS):
            lengths = jnp.array(_LINK_LENGTHS)
        else:  # non-standard factorizations: uniform chain of the same reach
            lengths = jnp.full(self.num_links, sum(_LINK_LENGTHS) / self.num_links)
        self.link_lengths = lengths
        self.masses = jnp.ones(self.num_links)
        self.inertias = self.masses * self.link_lengths**2 / 12.0

        # Standing pose: torso pointing straight down from the base, hip/knee
        # straight, ankle folded so the foot lies flat along +x.
        self._rest_joints = jnp.concatenate(
            [jnp.zeros(self.num_joints - 1), jnp.array([jnp.pi / 2])]
        )
        self._base_height = (
            float(jnp.sum(self.link_lengths[:-1])) + _STAND_CLEARANCE
        )

        # own joints (cos, sin, vel) + shared (torso_y, cos th, sin th, thd, vx, vy)
        self.num_obs_features = 3 * joints_per_agent + 6

    # ------------------------------------------------------------- kinematics
    def _body_frame(self, q: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """((L, 2) link-center positions, (L,) absolute link angles)."""
        base, th, alpha = q[:2], q[2], q[3:]
        phi = th + jnp.concatenate([jnp.zeros(1), jnp.cumsum(alpha)])  # (L,)
        u = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)  # (L, 2)
        steps = self.link_lengths[:, None] * u
        ends = base[None, :] + jnp.cumsum(steps, axis=0)
        centers = ends - 0.5 * steps
        return centers, phi

    def _contact_points(self, q: jnp.ndarray) -> jnp.ndarray:
        """(L+1, 2): the base plus every link far end — anything can hit ground."""
        base, th, alpha = q[:2], q[2], q[3:]
        phi = th + jnp.concatenate([jnp.zeros(1), jnp.cumsum(alpha)])
        u = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)
        ends = base[None, :] + jnp.cumsum(self.link_lengths[:, None] * u, axis=0)
        return jnp.concatenate([base[None, :], ends], axis=0)

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
        """Generalized ground-reaction force: J^T F via vjp of the kinematics."""
        pts, pts_dot = jax.jvp(self._contact_points, (q,), (qd,))
        depth = -pts[:, 1]
        f_n = jnp.where(depth > 0.0, _CONTACT_KP * depth - _CONTACT_KD * pts_dot[:, 1], 0.0)
        f_n = jnp.maximum(f_n, 0.0)
        f_t = jnp.clip(
            -_CONTACT_KT * pts_dot[:, 0], -_FRICTION_MU * f_n, _FRICTION_MU * f_n
        )
        forces = jnp.stack([f_t, f_n], axis=-1)  # (L+1, 2)
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
        rhs = tau + self._contact_force(q, qd) + damping - coriolis + dT_dq - dV_dq
        return jnp.linalg.solve(M, rhs)

    def _integrate(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray):
        """RK4, _SUBSTEPS per env step (same scheme as `maswimmer.py:_integrate`;
        more substeps because penalty contact sets the fastest eigenvalue)."""
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
        # Wrap joint angles only: th itself is bounded by the pitch termination,
        # and wrapping it would corrupt the pitch check.
        angles = jnp.mod(q[3:] + jnp.pi, 2 * jnp.pi) - jnp.pi
        q = jnp.concatenate([q[:3], angles])
        return q, qd

    # ----------------------------------------------------------------- health
    def _torso_height(self, q: jnp.ndarray) -> jnp.ndarray:
        centers, _ = self._body_frame(q)
        return centers[0, 1]

    def _pitch(self, q: jnp.ndarray) -> jnp.ndarray:
        """Torso deviation from the standing (straight-down) orientation."""
        rest = -jnp.pi / 2
        return jnp.arctan2(jnp.sin(q[2] - rest), jnp.cos(q[2] - rest))

    def _healthy(self, q: jnp.ndarray) -> jnp.ndarray:
        return (self._torso_height(q) > self.min_torso_height) & (
            jnp.abs(self._pitch(q)) < self.max_pitch
        )

    # -------------------------------------------------------------------- API
    def _observe(self, state: MaHopperState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        alpha = state.q[3:].reshape(a, jpa)
        alpha_d = state.qd[3:].reshape(a, jpa)
        shared = jnp.array(
            [
                self._torso_height(state.q),
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

    def reset(self, key: PRNGKey) -> Tuple[MaHopperState, TimeStep]:
        key, q_key = jax.random.split(key)
        noise = jax.random.uniform(
            q_key, (1 + self.num_joints,), minval=-0.05, maxval=0.05
        )
        q = jnp.concatenate(
            [
                jnp.array([0.0, self._base_height]),
                jnp.array([-jnp.pi / 2]) + noise[:1],
                self._rest_joints + noise[1:],
            ]
        )
        # Pose noise can tilt the foot below ground; shift the base so the
        # LOWEST contact point starts exactly at the standing clearance.
        lowest = jnp.min(self._contact_points(q)[:, 1])
        q = q.at[1].add(_STAND_CLEARANCE - lowest)
        state = MaHopperState(
            key=key,
            step_count=jnp.int32(0),
            q=q,
            qd=jnp.zeros(3 + self.num_joints),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: MaHopperState, action: jnp.ndarray
    ) -> Tuple[MaHopperState, TimeStep]:
        action = jnp.clip(action, -1.0, 1.0)  # (A, jpa)
        tau = jnp.concatenate(
            [jnp.zeros(3), action.reshape(self.num_joints) * self.torque_scale]
        )
        com_before = self._com(state.q)
        q, qd = self._integrate(state.q, state.qd, tau)

        step_count = state.step_count + 1
        new_state = MaHopperState(key=state.key, step_count=step_count, q=q, qd=qd)

        forward = (self._com(q)[0] - com_before[0]) / _DT
        ctrl = _CTRL_COST * jnp.sum(action**2)
        reward = jnp.repeat(
            (forward + _HEALTHY_BONUS - ctrl).astype(jnp.float32), self.num_agents
        )

        terminated = ~self._healthy(q)
        time_up = step_count >= self.time_limit
        obs = self._observe(new_state)
        timestep = TimeStep(
            step_type=jnp.where(
                terminated | time_up, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            # discount 0 only on real termination (fall); truncation bootstraps.
            discount=jnp.where(terminated, 0.0, 1.0).astype(jnp.float32)
            * jnp.ones(self.num_agents, dtype=jnp.float32),
            observation=obs,
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
    def unwrapped(self) -> "MaHopper":
        return self
