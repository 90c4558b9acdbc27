"""MaSwimmer: multi-agent swimmer locomotion with exact Lagrangian dynamics.

Completes the MaBrax-class continuous-control family (reference
`mava/wrappers/jaxmarl.py:376-405`, `configs/env/mabrax.yaml`) with a LOCOMOTION
task: where MaReacher is the manipulation benchmark (fixed-base arm reaching a
target), MaSwimmer is the halfcheetah/swimmer-style benchmark — a free-floating
articulated body that must coordinate its joints into a gait that moves the
center of mass forward. Joints are factorized across agents exactly like MaBrax
(swimmer_2x1 = 2 agents x 1 joint each on a 3-link chain).

The physics is the classic slender-body swimmer (MuJoCo's `swimmer.xml` model):
an N-link planar chain in a viscous medium whose drag is ANISOTROPIC — each link
resists motion normal to its axis much more than along it. Undulating the chain
as a traveling wave therefore produces net thrust; by the scallop theorem, with
isotropic drag no periodic gait can swim (a property the unit tests check).

Formulation (same autodiff-Lagrangian idiom as `mareacher.py` — no hand-rolled
Newton-Euler, no scatters; everything is tiny dense ops that vmap into batched
matmuls):

    q        = (x, y, th, a_1..a_J)   free base + relative joint angles
    T(q,qd)  = 1/2 sum_k m_k |c_k'|^2 + I_k phi_k'^2     (rod masses + inertias)
    M(q)     = d^2 T / d qd^2                            (jax.hessian)
    R(q,qd)  = 1/2 sum_k l_k [ c_n (v_k.n_k)^2 + c_t (v_k.t_k)^2 ]
               + 1/2 sum_k c_n (l_k^3/12) phi_k'^2       (Rayleigh dissipation of
                                                          drag distributed along
                                                          each rod)
    Q_drag   = -dR/dqd                                   (generalized drag force)
    M qdd    = tau + Q_drag - C(q,qd) qd + dT/dq         (Euler-Lagrange)

Task: cooperative locomotion. Each agent torques its own joints; the shared team
reward is the forward center-of-mass velocity minus a control cost (classic
swimmer shaping). Episodes truncate at `time_limit`; there is no failure state.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from mava_jax.utils import struct

from mava_jax import specs
from mava_jax.types import Observation, PRNGKey, StepType, TimeStep, restart

_DT = 0.04
_SUBSTEPS = 4
_TORQUE_SCALE = 1.0
_MAX_SPEED = 20.0  # rad/s and m/s safety clip; unreachable in normal play
_CTRL_COST = 0.001
# Rotor (armature) inertia added to each actuated joint coordinate, MuJoCo-style.
# A uniform chain's per-link rod inertia shrinks as 1/L^3 (1e-4 at 9 links),
# making the joint dynamics stiff far beyond RK4's stability region at the fixed
# substep; armature bounds the fastest joint eigenvalue at damping/armature ~ 6/s
# for ANY link count. It enters the kinetic energy as 1/2 A sum(alpha_dot^2) —
# a function of joint rates only — so translation invariance (momentum
# conservation, scallop-theorem checks) is untouched.
_ARMATURE = 0.05
_DRAG_NORMAL = 5.0  # per-unit-length drag normal to a link's axis
_DRAG_TANGENT = 0.1  # per-unit-length drag along a link's axis (anisotropy = thrust)
# Viscous damping at each actuated joint (MuJoCo-style rotor damping). Rod
# inertias are tiny (m l^2/12 ~ 3e-3), so without this a unit torque spins a
# joint past any speed clip — and clipping qd mid-integration acts as an
# EXTERNAL impulse that injects center-of-mass momentum (it made an isotropic-
# drag control "swim", violating the scallop theorem). Damping is an internal
# force (equal/opposite torques on adjacent links), so conservation tests and
# the scallop check stay exact; it bounds joint speed at tau/damping ~ 3 rad/s,
# far from the clip.
_JOINT_DAMPING = 0.3


@struct.dataclass
class MaSwimmerState:
    key: PRNGKey
    step_count: jnp.ndarray
    q: jnp.ndarray  # (3 + J,) = (x, y, th, joint angles)
    qd: jnp.ndarray  # (3 + J,)


class MaSwimmer:
    """Free-floating N-link swimmer, joints factorized across agents."""

    def __init__(
        self,
        num_agents: int = 2,
        joints_per_agent: int = 1,
        time_limit: int = 200,
        torque_scale: float = _TORQUE_SCALE,
        drag_normal: float = _DRAG_NORMAL,
        drag_tangent: float = _DRAG_TANGENT,
        joint_damping: float = _JOINT_DAMPING,
    ):
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_agents * joints_per_agent
        self.num_links = self.num_joints + 1
        self.time_limit = time_limit
        self.torque_scale = float(torque_scale)
        self.drag_normal = float(drag_normal)
        self.drag_tangent = float(drag_tangent)
        self.joint_damping = float(joint_damping)
        self.action_dim = joints_per_agent

        # Uniform chain: total length 1.0, total mass 1.0, rod inertia m*l^2/12.
        self.link_lengths = jnp.full(self.num_links, 1.0 / self.num_links)
        self.masses = jnp.full(self.num_links, 1.0 / self.num_links)
        self.inertias = self.masses * self.link_lengths**2 / 12.0

        # own joints (cos, sin, vel) + shared (cos th, sin th, th_dot, vx, vy)
        self.num_obs_features = 3 * joints_per_agent + 5

    # ------------------------------------------------------------- kinematics
    def _body_frame(self, q: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """((L, 2) link-center positions, (L,) absolute link angles)."""
        base, th, alpha = q[:2], q[2], q[3:]
        phi = th + jnp.concatenate([jnp.zeros(1), jnp.cumsum(alpha)])  # (L,)
        u = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)  # (L, 2) link axes
        steps = self.link_lengths[:, None] * u
        joint_pos = base[None, :] + jnp.cumsum(steps, axis=0)  # link end points
        centers = joint_pos - 0.5 * steps
        return centers, phi

    def _com(self, q: jnp.ndarray) -> jnp.ndarray:
        centers, _ = self._body_frame(q)
        return jnp.sum(self.masses[:, None] * centers, axis=0) / jnp.sum(self.masses)

    # --------------------------------------------------------------- dynamics
    def _velocities(
        self, q: jnp.ndarray, qd: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """((L, 2) link-center velocities, (L,) link angular velocities)."""
        return jax.jvp(self._body_frame, (q,), (qd,))[1]

    def _kinetic(self, q: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
        vel, omega = self._velocities(q, qd)
        return (
            0.5 * jnp.sum(self.masses[:, None] * vel**2)
            + 0.5 * jnp.sum(self.inertias * omega**2)
            + 0.5 * _ARMATURE * jnp.sum(qd[3:] ** 2)
        )

    def _rayleigh(self, q: jnp.ndarray, qd: jnp.ndarray) -> jnp.ndarray:
        """Dissipation function of drag distributed along each rod; the
        generalized drag force is exactly -dR/dqd."""
        vel, omega = self._velocities(q, qd)
        _, phi = self._body_frame(q)
        tangent = jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)
        normal = jnp.stack([-jnp.sin(phi), jnp.cos(phi)], axis=-1)
        v_t = jnp.sum(vel * tangent, axis=-1)
        v_n = jnp.sum(vel * normal, axis=-1)
        l = self.link_lengths
        trans = 0.5 * jnp.sum(l * (self.drag_normal * v_n**2 + self.drag_tangent * v_t**2))
        rot = 0.5 * jnp.sum(self.drag_normal * l**3 / 12.0 * omega**2)
        joints = 0.5 * self.joint_damping * jnp.sum(qd[3:] ** 2)
        return trans + rot + joints

    def mass_matrix(self, q: jnp.ndarray) -> jnp.ndarray:
        return jax.hessian(self._kinetic, argnums=1)(q, jnp.zeros_like(q))

    def _accel(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
        """Solve the Euler-Lagrange equation for qdd. `tau` is the full
        generalized actuation vector (zeros on the unactuated base coords)."""
        M = self.mass_matrix(q)
        momentum = lambda q_: jax.grad(self._kinetic, argnums=1)(q_, qd)
        coriolis = jax.jacfwd(momentum)(q) @ qd
        dT_dq = jax.grad(self._kinetic, argnums=0)(q, qd)
        drag = -jax.grad(self._rayleigh, argnums=1)(q, qd)
        rhs = tau + drag - coriolis + dT_dq
        return jnp.linalg.solve(M, rhs)

    def _integrate(self, q: jnp.ndarray, qd: jnp.ndarray, tau: jnp.ndarray):
        """RK4 on the coupled (q, qd) ODE, _SUBSTEPS per env step (same scheme
        and rationale as `mareacher.py:_integrate`)."""
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
        # Wrap angles; positions/energies are invariant to 2-pi shifts.
        angles = jnp.mod(q[2:] + jnp.pi, 2 * jnp.pi) - jnp.pi
        q = jnp.concatenate([q[:2], angles])
        return q, qd

    # -------------------------------------------------------------------- API
    def _observe(self, state: MaSwimmerState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        alpha = state.q[3:].reshape(a, jpa)
        alpha_d = state.qd[3:].reshape(a, jpa)
        com_vel = jax.jvp(self._com, (state.q,), (state.qd,))[1]
        shared = jnp.concatenate(
            [
                jnp.stack([jnp.cos(state.q[2]), jnp.sin(state.q[2])]),
                (state.qd[2] / _MAX_SPEED)[None],
                com_vel / _MAX_SPEED,
            ]
        )
        agents_view = jnp.concatenate(
            [
                jnp.cos(alpha),
                jnp.sin(alpha),
                alpha_d / _MAX_SPEED,
                jnp.broadcast_to(shared, (a, 5)),
            ],
            axis=-1,
        ).astype(jnp.float32)
        mask = jnp.ones((a, self.action_dim), dtype=jnp.bool_)
        return Observation(agents_view, mask, jnp.repeat(state.step_count, a))

    def reset(self, key: PRNGKey) -> Tuple[MaSwimmerState, TimeStep]:
        key, q_key = jax.random.split(key)
        # Small pose noise around the straight +x configuration (MuJoCo-style);
        # absolute (x, y) is gauge — start at the origin.
        noise = jax.random.uniform(
            q_key, (1 + self.num_joints,), minval=-0.1, maxval=0.1
        )
        q = jnp.concatenate([jnp.zeros(2), noise])
        state = MaSwimmerState(
            key=key,
            step_count=jnp.int32(0),
            q=q,
            qd=jnp.zeros(3 + self.num_joints),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: MaSwimmerState, action: jnp.ndarray
    ) -> Tuple[MaSwimmerState, TimeStep]:
        action = jnp.clip(action, -1.0, 1.0)  # (A, jpa)
        tau = jnp.concatenate(
            [jnp.zeros(3), action.reshape(self.num_joints) * self.torque_scale]
        )
        com_before = self._com(state.q)
        q, qd = self._integrate(state.q, state.qd, tau)

        step_count = state.step_count + 1
        new_state = MaSwimmerState(
            key=state.key, step_count=step_count, q=q, qd=qd
        )
        forward = (self._com(q)[0] - com_before[0]) / _DT
        ctrl = _CTRL_COST * jnp.sum(action**2)
        reward = jnp.repeat((forward - ctrl).astype(jnp.float32), self.num_agents)
        obs = self._observe(new_state)
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=jnp.where(
                time_up, jnp.int32(StepType.LAST), jnp.int32(StepType.MID)
            ),
            reward=reward,
            discount=jnp.ones(self.num_agents, dtype=jnp.float32),
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
    def unwrapped(self) -> "MaSwimmer":
        return self
