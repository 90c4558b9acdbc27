"""MaAnt: multi-agent quadruped — the 3D member of the MaBrax-class family.

`ant_4x2` is the flagship MaBrax scenario (reference
`mava/wrappers/jaxmarl.py:376-405`, `mava/configs/env/mabrax.yaml:7`): the
MuJoCo ant's 8 joints factorized one LEG (hip + ankle) per agent. The planar
engines (MaHopper/MaCheetah/MaWalker) cannot express it — the ant is
genuinely three-dimensional (legs at four azimuths, roll/pitch/yaw base).

3D in the same autodiff-Lagrangian idiom as the planar envs,
lifted to 3D by modelling every body as a static cloud of POINT MASSES:

    q  = (x, y, z, roll, pitch, yaw, hip_0, ankle_0, ..., hip_3, ankle_3)
    points(q) : R^14 -> R^(P,3)   world positions of all mass points
    M(q)      = J^T diag(m) J + diag(armature),  J = d points / d q
    M qdd     = J^T m (g - Jdot qd) + tau + J^T F_contact - c qd_joints - k_limit

(the Newton-d'Alembert point-mass form — see `pointcloud3d.py`; gravity and
every Coriolis/centrifugal term collapse into the bias acceleration Jdot qd,
and the whole dynamics is one `jacfwd` + two nested `jvp`s + one `vjp` of the
kinematics; a Lagrangian-equivalence test pins it against the hessian path)

Point clouds stand in for inertia tensors: the torso is its center plus six
surface points (giving full rotational inertia about every axis), each leg
link is a 3-point rod (1/4, 1/2, 1/4 masses — rod-like inertia). No
Newton-Euler recursion, no quaternion algebra, no scatters: the whole
dynamics is jvp/vjp/jacfwd of one dense (P,3) kinematics function, which XLA
fuses into a handful of small matmuls. Ground contact is the spring-damper
normal + Coulomb-clamped tangential model of `mahopper.py`, with the
tangential clamp applied per horizontal axis (box friction cone).

Base orientation uses roll-pitch-yaw (R = Rz Ry Rx) — autodiff-friendly and
singular only at pitch = +-pi/2, which the healthy-state termination (|roll|,
|pitch| < 1.2) keeps the live dynamics away from; a small rotational armature
on the Euler rates keeps M positive definite even while a dead body tumbles.

Task (MuJoCo Ant-v4 semantics): shared team reward = forward (+x)
center-of-mass velocity + 1.0 healthy bonus - 0.5 * ctrl cost; TERMINATES
(discount 0) when the torso leaves the healthy height band or rolls/pitches
over. Like MuJoCo's ant, the passive body STANDS (joint-limit bracing), so
staying alive is easy but locomotion must be coordinated across agents.

Factorizations: legs are ordered (front-left, front-right, back-left,
back-right), joints (hip, ankle) within each leg, so `ant_4x2` = one leg per
agent, `ant_2x4` = front half / back half, `ant_8x1` = one joint per agent —
all plain reshapes of the same joint vector, as in MaBrax.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.envs.pointcloud3d import newton_accel
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_TORQUE_SCALE = 20.0
_MAX_SPEED = 50.0
_CTRL_COST = 0.5  # Ant-v4 ctrl_cost_weight
_HEALTHY_BONUS = 1.0
_ARMATURE = 0.1
_BASE_ROT_ARMATURE = 0.01  # keeps M PD through the Euler singularity
_JOINT_DAMPING = 0.5
_CONTACT_KP = 8000.0
_CONTACT_KD = 150.0
_CONTACT_KT = 300.0
_FRICTION_MU = 0.9
_STAND_CLEARANCE = 0.005
_LIMIT_KP = 200.0
_LIMIT_KD = 5.0

_TORSO_RADIUS = 0.25
_TORSO_MASS = 3.0
_UPPER_LEN = 0.28
_LOWER_LEN = 0.55
_LEG_MASS = 0.5  # per link
_ANKLE_REST = 1.0  # rad below horizontal at rest
# (hip, ankle) ranges, same for every leg
_HIP_RANGE = (-0.7, 0.7)
_ANKLE_RANGE = (-0.35, 0.8)
# leg azimuths in the torso frame: front-left, front-right, back-left, back-right
_LEG_AZIMUTHS = (np.pi / 4, -np.pi / 4, 3 * np.pi / 4, -3 * np.pi / 4)


def _rpy_matrix(rpy: jnp.ndarray) -> jnp.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = jnp.cos(rpy[0]), jnp.sin(rpy[0])
    cp, sp = jnp.cos(rpy[1]), jnp.sin(rpy[1])
    cy, sy = jnp.cos(rpy[2]), jnp.sin(rpy[2])
    return jnp.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


@struct.dataclass
class MaAntState:
    key: PRNGKey
    step_count: jnp.ndarray
    q: jnp.ndarray  # (14,) = (x, y, z, roll, pitch, yaw, 4 x (hip, ankle))
    qd: jnp.ndarray  # (14,)


class MaAnt:
    """3D quadruped (torso + 4 two-link legs), legs factorized across agents."""

    def __init__(
        self,
        num_agents: int = 4,
        joints_per_agent: int = 2,
        time_limit: int = 250,
        torque_scale: float = _TORQUE_SCALE,
        joint_damping: float = _JOINT_DAMPING,
        gravity: float = _GRAVITY,
        min_torso_height: float = 0.2,
        max_torso_height: float = 1.0,
        max_tilt: float = 1.2,
    ):
        num_joints = num_agents * joints_per_agent
        assert num_joints == 8, (
            "MaAnt has exactly 8 joints; choose a factorization with "
            f"num_agents*joints_per_agent == 8, got {num_joints}"
        )
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_joints
        self.time_limit = time_limit
        self.torque_scale = float(torque_scale)
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.min_torso_height = float(min_torso_height)
        self.max_torso_height = float(max_torso_height)
        self.max_tilt = float(max_tilt)
        self.action_dim = joints_per_agent

        self._azimuths = jnp.array(_LEG_AZIMUTHS)
        lo = [_HIP_RANGE[0], _ANKLE_RANGE[0]] * 4
        hi = [_HIP_RANGE[1], _ANKLE_RANGE[1]] * 4
        self._joint_lo = jnp.array(lo)
        self._joint_hi = jnp.array(hi)

        # Torso point cloud: center + 6 surface points along +-x, +-y, +-z.
        axes = np.concatenate([np.eye(3), -np.eye(3)], axis=0)
        self._torso_offsets = jnp.array(
            np.concatenate([np.zeros((1, 3)), _TORSO_RADIUS * axes], axis=0)
        )
        self._torso_masses = jnp.array([0.4] + [0.1] * 6) * _TORSO_MASS
        self._rod_fracs = jnp.array([0.25, 0.5, 0.25]) * _LEG_MASS

        # masses aligned with _points(): 7 torso + per leg (3 upper + 3 lower)
        self._point_masses = jnp.concatenate(
            [self._torso_masses] + [jnp.tile(self._rod_fracs, 2)] * 4
        )
        self.total_mass = float(jnp.sum(self._point_masses))

        # own joints (cos, sin, vel) + shared (z, rpy cos/sin, lin vel, ang vel)
        self.num_obs_features = 3 * joints_per_agent + 13

    # ------------------------------------------------------------- kinematics
    def _leg_local(self, alpha: jnp.ndarray):
        """Torso-frame attach/knee/foot for all 4 legs. alpha: (8,) joints."""
        hip, ankle = alpha[0::2], alpha[1::2]  # (4,), (4,)
        beta = self._azimuths + hip
        e = jnp.stack([jnp.cos(beta), jnp.sin(beta), jnp.zeros(4)], axis=-1)
        u = jnp.stack(
            [jnp.cos(self._azimuths), jnp.sin(self._azimuths), jnp.zeros(4)], axis=-1
        )
        attach = _TORSO_RADIUS * u  # (4, 3)
        knee = attach + _UPPER_LEN * e
        psi = _ANKLE_REST + ankle
        down = jnp.array([0.0, 0.0, 1.0])
        d = jnp.cos(psi)[:, None] * e - jnp.sin(psi)[:, None] * down[None, :]
        foot = knee + _LOWER_LEN * d
        return attach, knee, foot

    def _points(self, q: jnp.ndarray) -> jnp.ndarray:
        """(P, 3) world positions of every mass point (P = 7 + 4*6 = 31)."""
        p, rpy, alpha = q[:3], q[3:6], q[6:]
        R = _rpy_matrix(rpy)
        attach, knee, foot = self._leg_local(alpha)
        upper = jnp.stack([attach, 0.5 * (attach + knee), knee], axis=1)  # (4,3,3)
        lower = jnp.stack([knee, 0.5 * (knee + foot), foot], axis=1)
        local = jnp.concatenate(
            [self._torso_offsets, jnp.concatenate([upper, lower], axis=1).reshape(-1, 3)]
        )
        return p[None, :] + local @ R.T

    def _contact_points(self, q: jnp.ndarray) -> jnp.ndarray:
        """(14, 3): feet + knees + the 6 torso surface points."""
        p, rpy, alpha = q[:3], q[3:6], q[6:]
        R = _rpy_matrix(rpy)
        _, knee, foot = self._leg_local(alpha)
        local = jnp.concatenate([foot, knee, self._torso_offsets[1:]])
        return p[None, :] + local @ R.T

    def _com(self, q: jnp.ndarray) -> jnp.ndarray:
        pts = self._points(q)
        return jnp.sum(self._point_masses[:, None] * pts, axis=0) / self.total_mass

    # --------------------------------------------------------------- dynamics
    def _kinetic(self, q: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
        vel = jax.jvp(self._points, (q,), (qd,))[1]
        return (
            0.5 * jnp.sum(self._point_masses[:, None] * vel**2)
            + 0.5 * _ARMATURE * jnp.sum(qd[6:] ** 2)
            + 0.5 * _BASE_ROT_ARMATURE * jnp.sum(qd[3:6] ** 2)
        )

    def _potential(self, q: jnp.ndarray) -> jnp.ndarray:
        pts = self._points(q)
        return self.gravity * jnp.sum(self._point_masses * pts[:, 2])

    def _contact_force(self, q: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
        pts, pts_dot = jax.jvp(self._contact_points, (q,), (qd,))
        depth = -pts[:, 2]
        f_n = jnp.where(
            depth > 0.0, _CONTACT_KP * depth - _CONTACT_KD * pts_dot[:, 2], 0.0
        )
        f_n = jnp.maximum(f_n, 0.0)
        bound = _FRICTION_MU * f_n[:, None]
        f_t = jnp.clip(-_CONTACT_KT * pts_dot[:, :2], -bound, bound)
        forces = jnp.concatenate([f_t, f_n[:, None]], axis=-1)
        _, vjp = jax.vjp(self._contact_points, q)
        return vjp(forces)[0]

    def _armature_diag(self) -> jnp.ndarray:
        return jnp.concatenate(
            [
                jnp.zeros(3),
                jnp.full(3, _BASE_ROT_ARMATURE),
                jnp.full(self.num_joints, _ARMATURE),
            ]
        )

    def mass_matrix(self, q: jnp.ndarray) -> jnp.ndarray:
        J = jax.jacfwd(self._points)(q)
        mJ = self._point_masses[:, None, None] * J
        return jnp.einsum("pin,pim->nm", mJ, J) + jnp.diag(self._armature_diag())

    def _accel(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
        # Newton-d'Alembert point-cloud form (pointcloud3d.newton_accel):
        # algebraically identical to the Lagrangian hessian path (pinned by
        # test_newton_accel_matches_lagrangian) with a ~4x smaller graph.
        damping = -self.joint_damping * jnp.concatenate([jnp.zeros(6), qd[6:]])
        alpha, alpha_d = q[6:], qd[6:]
        excess = jnp.maximum(alpha - self._joint_hi, 0.0) + jnp.minimum(
            alpha - self._joint_lo, 0.0
        )
        limit_tau = -_LIMIT_KP * excess - _LIMIT_KD * alpha_d * (excess != 0.0)
        limits = jnp.concatenate([jnp.zeros(6), limit_tau])
        applied = tau + self._contact_force(q, qd) + damping + limits
        return newton_accel(
            self._points,
            self._point_masses,
            self._armature_diag(),
            self.gravity,
            q,
            qd,
            applied,
        )

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
        # Wrap the joints; the Euler angles stay unwrapped (bounded by the
        # tilt termination, and wrapping would corrupt the healthy check).
        angles = jnp.mod(q[6:] + jnp.pi, 2 * jnp.pi) - jnp.pi
        q = jnp.concatenate([q[:6], angles])
        return q, qd

    # ----------------------------------------------------------------- health
    def _healthy(self, q: jnp.ndarray) -> jnp.ndarray:
        z_ok = (q[2] > self.min_torso_height) & (q[2] < self.max_torso_height)
        tilt_ok = (jnp.abs(q[3]) < self.max_tilt) & (jnp.abs(q[4]) < self.max_tilt)
        return z_ok & tilt_ok

    # -------------------------------------------------------------------- API
    def _observe(self, state: MaAntState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        alpha = state.q[6:].reshape(a, jpa)
        alpha_d = state.qd[6:].reshape(a, jpa)
        rpy = state.q[3:6]
        shared = jnp.concatenate(
            [
                state.q[2:3],
                jnp.cos(rpy),
                jnp.sin(rpy),
                state.qd[:3] / 10.0,
                state.qd[3:6] / 10.0,
            ]
        )
        agents_view = jnp.concatenate(
            [
                jnp.cos(alpha),
                jnp.sin(alpha),
                alpha_d / 10.0,
                jnp.broadcast_to(shared, (a, 13)),
            ],
            axis=-1,
        ).astype(jnp.float32)
        mask = jnp.ones((a, self.action_dim), dtype=jnp.bool_)
        return Observation(agents_view, mask, jnp.repeat(state.step_count, a))

    def reset(self, key: PRNGKey) -> Tuple[MaAntState, TimeStep]:
        key, q_key = jax.random.split(key)
        noise = jax.random.uniform(
            q_key, (3 + self.num_joints,), minval=-0.05, maxval=0.05
        )
        q = jnp.concatenate([jnp.zeros(3), noise[:3], noise[3:]])
        # Drop the base so the lowest contact point starts at the clearance.
        lowest = jnp.min(self._contact_points(q)[:, 2])
        q = q.at[2].add(_STAND_CLEARANCE - lowest)
        state = MaAntState(
            key=key,
            step_count=jnp.int32(0),
            q=q,
            qd=jnp.zeros(6 + self.num_joints),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: MaAntState, action: jnp.ndarray
    ) -> Tuple[MaAntState, TimeStep]:
        action = jnp.clip(action, -1.0, 1.0)  # (A, jpa)
        tau = jnp.concatenate(
            [jnp.zeros(6), action.reshape(self.num_joints) * self.torque_scale]
        )
        com_before = self._com(state.q)
        q, qd = self._integrate(state.q, state.qd, tau)

        step_count = state.step_count + 1
        new_state = MaAntState(key=state.key, step_count=step_count, q=q, qd=qd)

        forward = (self._com(q)[0] - com_before[0]) / _DT
        ctrl = _CTRL_COST * jnp.sum(action**2)
        reward = jnp.repeat(
            (forward + _HEALTHY_BONUS - ctrl).astype(jnp.float32), self.num_agents
        )

        terminated = ~self._healthy(q)
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
    def unwrapped(self) -> "MaAnt":
        return self
