"""MaHumanoid: two-agent humanoid — completes the MaBrax scenario list.

`humanoid_9|8` is the heterogeneous MaBrax scenario (reference
`mava/configs/env/mabrax.yaml:7`, wrapper `mava/wrappers/jaxmarl.py:376-405`):
the MuJoCo humanoid's 17 actuated joints split into an UPPER-body agent
(abdomen x3, two shoulders x2, two elbows — 9 joints) and a LOWER-body agent
(two 3-DOF hips, two knees — 8 joints). The split is heterogeneous; since the
framework's Observation/action contract is rectangular, the lower agent is
PADDED to 9 slots with `action_mask[1, 8] = False` — the padded column is
ignored by the dynamics and excluded from the control cost.

Same 3D point-cloud engine as `maant.py` — every body is a static cloud of
point masses, the full kinematics is one dense `points(q) -> (P,3)` function,
and the dynamics are the Newton-d'Alembert form of `pointcloud3d.py` (mass
matrix = J^T m J + armature from one `jacfwd`; gravity/Coriolis collapse into
the `Jdot qd` bias; contact via `jax.vjp`). What is NEW here is the kinematic
DEPTH: 3-DOF ball joints (abdomen, hips) composed as Rz*Ry*Rx rotation chains
through an 11-body tree (pelvis -> torso -> head/arms, pelvis -> legs), q in
R^23 = 6 free-base + 17 joints.

Task (MuJoCo Humanoid-v4 semantics): shared team reward = 1.25 * forward
center-of-mass velocity + 5.0 healthy bonus - 0.1 * ctrl cost; TERMINATES
(discount 0) when the pelvis leaves the healthy height band or the base tilts
past `max_tilt`. Unlike the ant, the passive humanoid FALLS in under a
second — both agents must coordinate (legs balance, trunk stabilizes) just to
collect the alive bonus, which is why this is the hardest MaBrax task.
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
_MAX_SPEED = 50.0
_CTRL_COST = 0.1  # Humanoid-v4 ctrl_cost_weight
_HEALTHY_BONUS = 5.0
_FORWARD_WEIGHT = 1.25
_ARMATURE = 0.1
_BASE_ROT_ARMATURE = 0.02
_JOINT_DAMPING = 1.0
_CONTACT_KP = 12000.0
_CONTACT_KD = 250.0
_CONTACT_KT = 400.0
_FRICTION_MU = 0.9
_STAND_CLEARANCE = 0.005
_LIMIT_KP = 300.0
_LIMIT_KD = 8.0

# geometry (m)
_PELVIS_HALF = 0.12
_TORSO_LEN = 0.50
_HEAD_OFF = 0.15
_SHOULDER_HALF = 0.17
_UARM_LEN = 0.28
_FARM_LEN = 0.25
_HIP_HALF = 0.10
_THIGH_LEN = 0.40
_SHIN_LEN = 0.40
_TOE_LEN = 0.18

# joint order: upper agent then lower agent.
#   0-2   abdomen_z, abdomen_y, abdomen_x
#   3-5   right_shoulder1, right_shoulder2, right_elbow
#   6-8   left_shoulder1, left_shoulder2, left_elbow
#   9-12  right_hip_x, right_hip_z, right_hip_y, right_knee
#   13-16 left_hip_x, left_hip_z, left_hip_y, left_knee
_NUM_JOINTS = 17
_UPPER = 9  # agent 0 owns joints [0:9], agent 1 owns [9:17]
_JOINT_LO = (
    -0.7, -1.3, -0.6,
    -1.5, -1.5, -1.5,
    -1.5, -1.5, -1.5,
    -0.4, -0.6, -1.9, -2.6,
    -0.4, -0.6, -1.9, -2.6,
)
_JOINT_HI = (
    0.7, 0.5, 0.6,
    1.5, 1.5, 0.9,
    1.5, 1.5, 0.9,
    0.4, 0.6, 0.35, 0.0,
    0.4, 0.6, 0.35, 0.0,
)
_TORQUE = (
    40.0, 40.0, 40.0,
    15.0, 15.0, 10.0,
    15.0, 15.0, 10.0,
    40.0, 40.0, 40.0, 40.0,
    40.0, 40.0, 40.0, 40.0,
)

# masses (kg)
_M_PELVIS = 2.5
_M_TORSO = 4.0
_M_HEAD = 1.0
_M_THIGH = 1.5
_M_SHIN = 1.0
_M_TOE = 0.2
_M_UARM = 0.5
_M_FARM = 0.3


def _rx(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _ry(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rz(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rod(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(3, 3) endpoints + midpoint of a link — the 3-point rod cloud."""
    return jnp.stack([a, 0.5 * (a + b), b])


_ROD_FRACS = np.array([0.25, 0.5, 0.25])


@struct.dataclass
class MaHumanoidState:
    key: PRNGKey
    step_count: jnp.ndarray
    q: jnp.ndarray  # (23,) = (x, y, z, roll, pitch, yaw, 17 joints)
    qd: jnp.ndarray  # (23,)


class MaHumanoid:
    """Two-agent humanoid (upper body 9 joints | lower body 8, padded to 9)."""

    def __init__(
        self,
        time_limit: int = 250,
        joint_damping: float = _JOINT_DAMPING,
        gravity: float = _GRAVITY,
        min_pelvis_height: float = 0.55,
        max_pelvis_height: float = 1.2,
        max_tilt: float = 1.0,
    ):
        self.num_agents = 2
        self.num_joints = _NUM_JOINTS
        self.action_dim = _UPPER  # padded rectangle (2, 9)
        self.time_limit = time_limit
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.min_pelvis_height = float(min_pelvis_height)
        self.max_pelvis_height = float(max_pelvis_height)
        self.max_tilt = float(max_tilt)

        self._joint_lo = jnp.array(_JOINT_LO)
        self._joint_hi = jnp.array(_JOINT_HI)
        self._torque = jnp.array(_TORQUE)

        # pelvis cloud: center + 4 points at +-x, +-y
        axes = np.concatenate([np.eye(3)[:2], -np.eye(3)[:2]], axis=0)
        self._pelvis_offsets = jnp.array(
            np.concatenate([np.zeros((1, 3)), _PELVIS_HALF * axes], axis=0)
        )
        pelvis_m = np.array([0.4] + [0.15] * 4) * _M_PELVIS

        # masses aligned with _points() ordering (see _points)
        rod = _ROD_FRACS
        self._point_masses = jnp.array(
            np.concatenate(
                [
                    pelvis_m,  # 5 pelvis
                    rod * _M_TORSO,  # 3 torso
                    [_M_HEAD],  # 1 head
                    rod * _M_UARM, rod * _M_FARM,  # right arm 6
                    rod * _M_UARM, rod * _M_FARM,  # left arm 6
                    rod * _M_THIGH, rod * _M_SHIN, [_M_TOE],  # right leg 7
                    rod * _M_THIGH, rod * _M_SHIN, [_M_TOE],  # left leg 7
                ]
            )
        )
        self.total_mass = float(jnp.sum(self._point_masses))

        # own joints (cos, sin, vel) padded to 9 + shared base features
        self.num_obs_features = 3 * _UPPER + 13

    # ------------------------------------------------------------- kinematics
    def _bodies(self, q: jnp.ndarray):
        """World-frame anchor points of every body (the full kinematic tree)."""
        p, rpy, a = q[:3], q[3:6], q[6:]
        from mava_jax.envs.maant import _rpy_matrix

        R0 = _rpy_matrix(rpy)

        # trunk
        R_t = R0 @ _rz(a[0]) @ _ry(a[1]) @ _rx(a[2])
        torso_base = p + R0 @ jnp.array([0.0, 0.0, _PELVIS_HALF])
        torso_top = torso_base + R_t @ jnp.array([0.0, 0.0, _TORSO_LEN])
        head = torso_top + R_t @ jnp.array([0.0, 0.0, _HEAD_OFF])

        down = jnp.array([0.0, 0.0, -1.0])

        def arm(sh1, sh2, elb, side):
            sh_at = torso_top + R_t @ jnp.array([0.0, side * _SHOULDER_HALF, -0.05])
            R_u = R_t @ _rx(sh1) @ _ry(sh2)
            elbow = sh_at + R_u @ (down * _UARM_LEN)
            R_f = R_u @ _ry(elb)
            hand = elbow + R_f @ (down * _FARM_LEN)
            return sh_at, elbow, hand

        r_sh, r_elb, r_hand = arm(a[3], a[4], a[5], -1.0)
        l_sh, l_elb, l_hand = arm(a[6], a[7], a[8], 1.0)

        def leg(hx, hz, hy, kn, side):
            hip_at = p + R0 @ jnp.array([0.0, side * _HIP_HALF, -0.05])
            R_th = R0 @ _rx(hx) @ _rz(hz) @ _ry(hy)
            knee = hip_at + R_th @ (down * _THIGH_LEN)
            R_sh = R_th @ _ry(kn)
            heel = knee + R_sh @ (down * _SHIN_LEN)
            toe = heel + R_sh @ jnp.array([_TOE_LEN, 0.0, 0.0])
            return hip_at, knee, heel, toe

        r_hip, r_knee, r_heel, r_toe = leg(a[9], a[10], a[11], a[12], -1.0)
        l_hip, l_knee, l_heel, l_toe = leg(a[13], a[14], a[15], a[16], 1.0)

        return {
            "p": p, "R0": R0,
            "torso_base": torso_base, "torso_top": torso_top, "head": head,
            "r_sh": r_sh, "r_elb": r_elb, "r_hand": r_hand,
            "l_sh": l_sh, "l_elb": l_elb, "l_hand": l_hand,
            "r_hip": r_hip, "r_knee": r_knee, "r_heel": r_heel, "r_toe": r_toe,
            "l_hip": l_hip, "l_knee": l_knee, "l_heel": l_heel, "l_toe": l_toe,
        }

    def _points(self, q: jnp.ndarray) -> jnp.ndarray:
        """(P, 3) world positions of every mass point (P = 35)."""
        b = self._bodies(q)
        pelvis = b["p"][None, :] + self._pelvis_offsets @ b["R0"].T
        return jnp.concatenate(
            [
                pelvis,
                _rod(b["torso_base"], b["torso_top"]),
                b["head"][None, :],
                _rod(b["r_sh"], b["r_elb"]), _rod(b["r_elb"], b["r_hand"]),
                _rod(b["l_sh"], b["l_elb"]), _rod(b["l_elb"], b["l_hand"]),
                _rod(b["r_hip"], b["r_knee"]), _rod(b["r_knee"], b["r_heel"]),
                b["r_toe"][None, :],
                _rod(b["l_hip"], b["l_knee"]), _rod(b["l_knee"], b["l_heel"]),
                b["l_toe"][None, :],
            ]
        )

    def _contact_points(self, q: jnp.ndarray) -> jnp.ndarray:
        """(13, 3): feet (heel+toe), knees, hands, elbows, head, pelvis, torso top."""
        b = self._bodies(q)
        return jnp.stack(
            [
                b["r_heel"], b["r_toe"], b["l_heel"], b["l_toe"],
                b["r_knee"], b["l_knee"],
                b["r_hand"], b["l_hand"], b["r_elb"], b["l_elb"],
                b["head"], b["p"], b["torso_top"],
            ]
        )

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
                jnp.full(_NUM_JOINTS, _ARMATURE),
            ]
        )

    def mass_matrix(self, q: jnp.ndarray) -> jnp.ndarray:
        J = jax.jacfwd(self._points)(q)
        mJ = self._point_masses[:, None, None] * J
        return jnp.einsum("pin,pim->nm", mJ, J) + jnp.diag(self._armature_diag())

    def _accel(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
        # Newton-d'Alembert point-cloud form (pointcloud3d.newton_accel): same
        # dynamics as the Lagrangian hessian path with a ~4x smaller autodiff
        # graph — what keeps the 23-DOF compile tractable.
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
        angles = jnp.mod(q[6:] + jnp.pi, 2 * jnp.pi) - jnp.pi
        q = jnp.concatenate([q[:6], angles])
        return q, qd

    # ----------------------------------------------------------------- health
    def _healthy(self, q: jnp.ndarray) -> jnp.ndarray:
        z_ok = (q[2] > self.min_pelvis_height) & (q[2] < self.max_pelvis_height)
        tilt_ok = (jnp.abs(q[3]) < self.max_tilt) & (jnp.abs(q[4]) < self.max_tilt)
        return z_ok & tilt_ok

    # ------------------------------------------------------------- pad helpers
    def _pad_split(self, alpha: jnp.ndarray) -> jnp.ndarray:
        """(17,) joint-space vector -> (2, 9) padded per-agent view."""
        upper = alpha[:_UPPER]
        lower = jnp.concatenate([alpha[_UPPER:], jnp.zeros(1, alpha.dtype)])
        return jnp.stack([upper, lower])

    # -------------------------------------------------------------------- API
    def _observe(self, state: MaHumanoidState) -> Observation:
        alpha = self._pad_split(state.q[6:])  # (2, 9)
        alpha_d = self._pad_split(state.qd[6:])
        # the padded slot reads (0, 0, 0), not (cos 0 = 1, ...)
        real = self._pad_split(jnp.ones(_NUM_JOINTS))
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
                jnp.cos(alpha) * real,
                jnp.sin(alpha),
                alpha_d / 10.0,
                jnp.broadcast_to(shared, (2, 13)),
            ],
            axis=-1,
        ).astype(jnp.float32)
        mask = jnp.array(
            [[True] * _UPPER, [True] * (_NUM_JOINTS - _UPPER) + [False]]
        )
        return Observation(agents_view, mask, jnp.repeat(state.step_count, 2))

    def reset(self, key: PRNGKey) -> Tuple[MaHumanoidState, TimeStep]:
        key, q_key = jax.random.split(key)
        noise = jax.random.uniform(
            q_key, (3 + _NUM_JOINTS,), minval=-0.03, maxval=0.03
        )
        q = jnp.concatenate([jnp.zeros(3), noise[:3], noise[3:]])
        lowest = jnp.min(self._contact_points(q)[:, 2])
        q = q.at[2].add(_STAND_CLEARANCE - lowest)
        state = MaHumanoidState(
            key=key, step_count=jnp.int32(0), q=q, qd=jnp.zeros(6 + _NUM_JOINTS)
        )
        return state, restart(self._observe(state), {}, 2)

    def step(
        self, state: MaHumanoidState, action: jnp.ndarray
    ) -> Tuple[MaHumanoidState, TimeStep]:
        action = jnp.clip(action, -1.0, 1.0)  # (2, 9), [1, 8] is padding
        joint_act = jnp.concatenate([action[0], action[1, : _NUM_JOINTS - _UPPER]])
        tau = jnp.concatenate([jnp.zeros(6), joint_act * self._torque])
        com_before = self._com(state.q)
        q, qd = self._integrate(state.q, state.qd, tau)

        step_count = state.step_count + 1
        new_state = MaHumanoidState(key=state.key, step_count=step_count, q=q, qd=qd)

        forward = (self._com(q)[0] - com_before[0]) / _DT
        ctrl = _CTRL_COST * jnp.sum(joint_act**2)  # padding excluded
        reward = jnp.repeat(
            (_FORWARD_WEIGHT * forward + _HEALTHY_BONUS - ctrl).astype(jnp.float32), 2
        )

        terminated = ~self._healthy(q)
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=jnp.where(
                terminated | time_up, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.where(terminated, 0.0, 1.0).astype(jnp.float32)
            * jnp.ones(2, dtype=jnp.float32),
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
    def unwrapped(self) -> "MaHumanoid":
        return self
