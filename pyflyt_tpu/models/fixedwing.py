"""Fixedwing (small airplane / acrowing) vehicle: aero dynamics + control map.

Batched-JAX re-implementation of /root/reference/PyFlyt/core/drones/fixedwing.py
(the same class also serves the "acrowing" parameter set — the reference has
no separate acrowing drone class). Five lifting surfaces + one puller motor on
a composite rigid body assembled from the URDF's point-mass links.

Simulation-order semantics preserved (aviary.py:478-500):
control (at control_hz) → physics (actuation/throttle lag + wrench from the
lagged read state) → state read (pre-integration → one-step sensor latency)
→ semi-implicit Euler integration at 240 Hz.

Flight modes (fixedwing.py:203-224):
  -1: [left_ail, right_ail, h_tail, v_tail, main_wing, thrust] raw commands
   0: [roll-pair, tail-pair, (unused), thrust] via the surface-assist map
      ids [0,0,1,1,2,3], signs [1,-1,1,-1,0,1] (fixedwing.py:137-140)

The multibody URDF becomes one rigid body: total mass Σmᵢ, CoM at the mass
centroid, point-mass inertia tensor Σ mᵢ(|dᵢ|²E − dᵢdᵢᵀ) (full 3×3 — the
z-offset tail adds xz terms). PyBullet-style readouts (base-origin position,
base-origin velocity) are reconstructed from the CoM state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import integrator
from pyflyt_tpu.core import math as pm
from pyflyt_tpu.core.params import load_vehicle_yaml
from pyflyt_tpu.core.state import Body6DoF
from pyflyt_tpu.ops import lifting_surfaces, motors


@dataclasses.dataclass(frozen=True)
class FixedwingConfig:
    """Static (trace-time) configuration."""

    drone_model: str = "fixedwing"
    control_hz: int = 120
    physics_hz: int = 240
    noisy_motors: bool = True
    starting_velocity: tuple = (20.0, 0.0, 0.0)  # fixedwing.py:33
    model_dir: str | None = None
    dtype: Any = jnp.float32

    def __post_init__(self):
        assert self.physics_hz % self.control_hz == 0

    @property
    def physics_period(self) -> float:
        return 1.0 / self.physics_hz

    @property
    def physics_control_ratio(self) -> int:
        return self.physics_hz // self.control_hz


@struct.dataclass
class FixedwingParams:
    mass: Array  # composite scalar
    inertia: Array  # (3, 3) full point-mass inertia about the CoM
    com_offset: Array  # (3,) base origin -> CoM, body frame
    contact_points: Array  # (k, 3) body-frame (base-origin) contact samples
    surfaces: lifting_surfaces.SurfaceParams
    motor: motors.MotorParams  # n = 1, positions already CoM-relative
    assist_ids: Array  # (6,) int32 mode-0 setpoint gather indices
    assist_signs: Array  # (6,)


def build_params(cfg: FixedwingConfig) -> FixedwingParams:
    """Loads the vehicle YAML and assembles the parameter pytree
    (reference ctor: fixedwing.py:69-171)."""
    y = load_vehicle_yaml(cfg.drone_model, cfg.model_dir)
    dt = cfg.dtype
    frame, mp, ctl = y["frame"], y["motor_params"], y["control_params"]

    masses = np.asarray(frame["link_masses"], dtype=np.float64)
    positions = np.asarray(frame["link_positions"], dtype=np.float64)
    mass = masses.sum()
    com = (masses[:, None] * positions).sum(0) / mass
    d = positions - com
    inertia = np.zeros((3, 3))
    for m, di in zip(masses, d):
        inertia += m * (np.dot(di, di) * np.eye(3) - np.outer(di, di))

    motor = motors.MotorParams(
        positions=jnp.asarray([np.asarray(mp["position"]) - com], dtype=dt),
        thrust_unit=jnp.asarray([mp["thrust_unit"]], dtype=dt),
        thrust_coef=jnp.asarray([mp["thrust_coef"]], dtype=dt),
        torque_coef=jnp.asarray([mp["torque_coef"]], dtype=dt),
        tau=jnp.asarray([mp["tau"]], dtype=dt),
        # no /4 here: single motor carries the full total_thrust
        # (fixedwing.py:146-148)
        max_rpm=jnp.asarray(
            [np.sqrt(mp["total_thrust"] / mp["thrust_coef"])], dtype=dt
        ),
        noise_ratio=jnp.asarray([mp["noise_ratio"]], dtype=dt),
    )

    return FixedwingParams(
        mass=jnp.asarray(mass, dtype=dt),
        inertia=jnp.asarray(inertia, dtype=dt),
        com_offset=jnp.asarray(com, dtype=dt),
        contact_points=jnp.asarray(frame["contact_points"], dtype=dt),
        surfaces=lifting_surfaces.build(y["surfaces"], dtype=dt),
        motor=motor,
        assist_ids=jnp.asarray(ctl["surface_assist_ids"], dtype=jnp.int32),
        assist_signs=jnp.asarray(ctl["surface_assist_signs"], dtype=dt),
    )


NUM_SURFACES = 5


@struct.dataclass
class FixedwingRead:
    """Lagged 'sensor' snapshot (reference update_state: fixedwing.py:249-276)."""

    view: Array  # (..., 4, 3) [ang_vel_b, euler, lin_vel_b, lin_pos] base-origin
    surface_local_vel: Array  # (..., 5, 3) body-frame air-relative surface vel


@struct.dataclass
class FixedwingState:
    body: Body6DoF  # CoM state, world ENU
    read: FixedwingRead
    actuation: Array  # (..., 5) surface deflections
    throttle: Array  # (..., 1)
    cmd: Array  # (..., 6) current actuator commands
    setpoint: Array  # (..., 6) mode -1 | (..., 4) mode 0
    contact: Array  # (...,) bool
    physics_steps: Array  # (...,) int32


def _base_kinematics(
    body: Body6DoF, params: FixedwingParams
) -> tuple[Array, Array, Array]:
    """(R, base_pos_world, base_vel_world) from the CoM state."""
    R = pm.quat_to_rotmat(body.quat)
    r = jnp.einsum("...ij,...j->...i", R, params.com_offset, precision="highest")
    base_pos = body.pos - r
    base_vel = body.lin_vel + jnp.cross(body.ang_vel, -r)
    return R, base_pos, base_vel


def update_state(
    body: Body6DoF,
    params: FixedwingParams,
    cfg: FixedwingConfig,
    physics_steps: Array,
    wind_fn=None,
) -> FixedwingRead:
    """Builds the read snapshot: PyBullet-equivalent base readouts + per-
    surface local velocities (fixedwing.py:249-276,
    lifting_surfaces.py:68-104)."""
    R, base_pos, base_vel = _base_kinematics(body, params)
    lin_vel_b = jnp.einsum("...ji,...j->...i", R, base_vel, precision="highest")
    ang_vel_b = jnp.einsum("...ji,...j->...i", R, body.ang_vel, precision="highest")
    euler = pm.quat_to_euler(body.quat)
    view = jnp.stack([ang_vel_b, euler, lin_vel_b, base_pos], axis=-2)

    # world velocity of each surface link: v_com + ω × R(r_s - r_com)
    r_s = jnp.einsum(
        "...ij,...nj->...ni", R, params.surfaces.positions - params.com_offset
    , precision="highest")
    v_s = body.lin_vel[..., None, :] + jnp.cross(body.ang_vel[..., None, :], r_s)
    if wind_fn is not None:
        pos_s = body.pos[..., None, :] + r_s
        v_s = v_s - wind_fn(physics_steps, pos_s)
    local = jnp.einsum("...ji,...nj->...ni", R, v_s, precision="highest")
    return FixedwingRead(view=view, surface_local_vel=local)


def init_state(
    params: FixedwingParams,
    cfg: FixedwingConfig,
    start_pos: Array,
    start_orn: Array,
    mode: int = 0,
    start_vel: Array | None = None,
) -> FixedwingState:
    """Reset state: base origin at ``start_pos``, world velocity
    ``cfg.starting_velocity`` (fixedwing.py:181-192) or the per-reset
    ``start_vel`` override (dogfight spawns along the forward vector —
    ma_fixedwing_dogfight_env.py:129-135)."""
    start_pos = jnp.asarray(start_pos, dtype=cfg.dtype)
    start_orn = jnp.asarray(start_orn, dtype=cfg.dtype)
    batch = start_pos.shape[:-1]
    quat = pm.euler_to_quat(start_orn)
    R = pm.quat_to_rotmat(quat)
    com_pos = start_pos + jnp.einsum("...ij,...j->...i", R, params.com_offset, precision="highest")
    if start_vel is None:
        vel = jnp.broadcast_to(
            jnp.asarray(cfg.starting_velocity, dtype=cfg.dtype), start_pos.shape
        )
    else:
        vel = jnp.asarray(start_vel, dtype=cfg.dtype)
    body = Body6DoF(
        pos=com_pos, quat=quat, lin_vel=vel, ang_vel=jnp.zeros_like(com_pos)
    )
    zeros = lambda n: jnp.zeros((*batch, n), dtype=cfg.dtype)
    return FixedwingState(
        body=body,
        read=update_state(body, params, cfg, jnp.zeros(batch, jnp.int32)),
        actuation=zeros(NUM_SURFACES),
        throttle=zeros(1),
        cmd=zeros(6),
        setpoint=zeros(6 if mode == -1 else 4),
        contact=jnp.zeros(batch, dtype=bool),
        physics_steps=jnp.zeros(batch, dtype=jnp.int32),
    )


def update_control(
    state: FixedwingState, params: FixedwingParams, cfg: FixedwingConfig, mode: int
) -> FixedwingState:
    """Maps the setpoint to the 6 actuator commands (fixedwing.py:226-247)."""
    if mode == -1:
        cmd = state.setpoint
    elif mode == 0:
        cmd = state.setpoint[..., params.assist_ids] * params.assist_signs
    else:
        raise ValueError(f"fixedwing flight mode must be -1 or 0, got {mode}")
    return state.replace(cmd=cmd)


def physics_iter(
    state: FixedwingState,
    params: FixedwingParams,
    cfg: FixedwingConfig,
    key: Array | None,
    wind_fn=None,
) -> FixedwingState:
    """One 240 Hz physics iteration (control NOT included — see ``step``)."""
    # actuator lags (lifting_surfaces.py:266, motors.py:126-134)
    actuation = lifting_surfaces.actuation_update(
        state.actuation, state.cmd[..., :NUM_SURFACES], params.surfaces,
        cfg.physics_period,
    )
    throttle = motors.throttle_update(
        state.throttle,
        state.cmd[..., NUM_SURFACES:],
        params.motor,
        cfg.physics_period,
        key if cfg.noisy_motors else None,
    )

    # wrench from the lagged read state
    f_aero, t_aero = lifting_surfaces.wrench(
        actuation, state.read.surface_local_vel, params.surfaces, params.com_offset
    )
    f_mot, t_mot = motors.wrench(throttle, params.motor)

    new_read = update_state(
        state.body, params, cfg, state.physics_steps, wind_fn
    )

    rb = integrator.RigidBodyParams(
        mass=params.mass, inertia=params.inertia, full_inertia=True
    )
    body = integrator.step(
        state.body, rb, f_aero + f_mot, t_aero + t_mot, cfg.physics_period
    )
    body, contact = integrator.ground_contact(
        body,
        rb,
        integrator.ContactGeom(points=params.contact_points - params.com_offset),
    )
    return state.replace(
        body=body,
        read=new_read,
        actuation=actuation,
        throttle=throttle,
        contact=contact,
        physics_steps=state.physics_steps + 1,
    )


def aux_state(state: FixedwingState) -> Array:
    """[surface deflections (5), motor throttle (1)] (fixedwing.py:278-281)."""
    return jnp.concatenate([state.actuation, state.throttle], axis=-1)


def step(
    state: FixedwingState,
    params: FixedwingParams,
    cfg: FixedwingConfig,
    mode: int,
    key: Array | None = None,
    wind_fn=None,
) -> tuple[FixedwingState, Array]:
    """One Aviary.step equivalent (physics_control_ratio physics iters with
    control gated at iteration 0 — aviary.py:478-500)."""
    any_contact = jnp.zeros_like(state.contact)
    for s in range(cfg.physics_control_ratio):
        if s % cfg.physics_control_ratio == 0:
            state = update_control(state, params, cfg, mode)
        if key is not None:
            key, sub = jax.random.split(key)
        else:
            sub = None
        state = physics_iter(state, params, cfg, sub, wind_fn)
        any_contact = any_contact | state.contact
    return state, any_contact
