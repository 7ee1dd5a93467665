"""QuadX (CrazyFlie 2.x) quadrotor: dynamics + cascaded flight controller.

Batched-JAX re-implementation of /root/reference/PyFlyt/core/drones/quadx.py.
The per-drone Python object becomes a ``QuadXState`` pytree and three pure
functions (``update_control`` / ``physics_iter`` / ``step``); arbitrary batch
dimensions stack on the left so one jitted program steps a whole fleet.

Simulation-order semantics preserved from the reference
(/root/reference/PyFlyt/core/aviary.py:478-500): per physics iteration,
  1. update_control   (at control_hz; uses the lagged read state)
  2. update_physics   (throttle lag + noise, wrench from the lagged state)
  3. update_state     (reads the *pre-integration* state → one-step latency)
  4. integrate        (semi-implicit Euler, 240 Hz)

Flight modes (quadx.py:254-311, fork modes 8-10 at :452-462):
  -1 raw motor PWM | 0 vp,vq,vr,T | 1 p,q,r,vz | 2 vp,vq,vr,z | 3 p,q,r,z
   4 u,v,vr,z | 5 u,v,vr,vz | 6 vx,vy,vr,vz | 7 x,y,r,z
   8 direct PWM | 9 motor-mix of RPYT | 10 gain-scheduled state feedback
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
from pyflyt_tpu.ops import boring_bodies, motors, pid
from pyflyt_tpu.ops.ga_pid import ga_pid_step

# ---------------------------------------------------------------------------
# configuration & parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuadXConfig:
    """Static (trace-time) configuration."""

    drone_model: str = "cf2x"
    control_hz: int = 120
    physics_hz: int = 240
    orn_conv: str = "ENU_FLU"
    noisy_motors: bool = True
    min_pwm: float = 0.05
    max_pwm: float = 1.0
    model_dir: str | None = None
    dtype: Any = jnp.float32

    def __post_init__(self):
        assert self.physics_hz % self.control_hz == 0, (
            f"`control_hz` ({self.control_hz}) must be a round denominator of "
            f"`physics_hz` ({self.physics_hz})."
        )
        assert self.orn_conv in ("ENU_FLU", "NED_FRD")

    @property
    def physics_period(self) -> float:
        return 1.0 / self.physics_hz

    @property
    def control_period(self) -> float:
        return 1.0 / self.control_hz

    @property
    def physics_control_ratio(self) -> int:
        return self.physics_hz // self.control_hz


@struct.dataclass
class QuadXParams:
    """Trainable/batchable numeric parameters loaded from the asset YAML."""

    mass: Array
    inertia: Array  # (3,)
    collision_half_extents: Array  # (3,)
    motor: motors.MotorParams
    motor_map: Array  # (4, 4) command [r,p,y,T] -> per-motor PWM
    drag_const_xyz: Array  # (3,) = ½ρ·Cd·A per axis
    drag_coef_pqr: Array  # scalar
    # PID gain banks (pid.PIDParams carries the control period statically)
    pid_ang_vel: pid.PIDParams
    pid_ang_pos: pid.PIDParams
    pid_lin_vel: pid.PIDParams
    pid_lin_pos: pid.PIDParams
    pid_z_pos: pid.PIDParams
    pid_z_vel: pid.PIDParams


# motor mix matrices (quadx.py:143-160)
_MOTOR_MAP_NED = np.array(
    [
        [-1.0, +1.0, +1.0, +1.0],
        [+1.0, -1.0, +1.0, +1.0],
        [+1.0, +1.0, -1.0, +1.0],
        [-1.0, -1.0, -1.0, +1.0],
    ]
)
_MOTOR_MAP_ENU = np.array(
    [
        [-1.0, -1.0, -1.0, +1.0],
        [+1.0, +1.0, -1.0, +1.0],
        [+1.0, -1.0, +1.0, +1.0],
        [-1.0, +1.0, +1.0, +1.0],
    ]
)


def build_params(cfg: QuadXConfig) -> QuadXParams:
    """Loads the vehicle YAML and assembles the parameter pytree."""
    y = load_vehicle_yaml(cfg.drone_model, cfg.model_dir)
    dt = cfg.dtype
    frame, mp, dp, ctl = (
        y["frame"],
        y["motor_params"],
        y["drag_params"],
        y["control_params"],
    )

    n = len(mp["positions"])
    thrust_coef = np.full((n,), mp["thrust_coef"])
    torque_coef = np.asarray(mp["torque_signs"]) * mp["torque_coef"]
    max_rpm = np.full((n,), np.sqrt(mp["total_thrust"] / (4 * mp["thrust_coef"])))
    motor = motors.MotorParams(
        positions=jnp.asarray(mp["positions"], dtype=dt),
        thrust_unit=jnp.tile(jnp.asarray(mp["thrust_unit"], dtype=dt), (n, 1)),
        thrust_coef=jnp.asarray(thrust_coef, dtype=dt),
        torque_coef=jnp.asarray(torque_coef, dtype=dt),
        tau=jnp.full((n,), mp["tau"], dtype=dt),
        max_rpm=jnp.asarray(max_rpm, dtype=dt),
        noise_ratio=jnp.full((n,), mp["noise_ratio"], dtype=dt),
    )

    def bank(name, size=None):
        c = ctl[name]
        arr = lambda v: jnp.atleast_1d(jnp.asarray(v, dtype=dt))
        return pid.PIDParams(
            kp=arr(c["kp"]), ki=arr(c["ki"]), kd=arr(c["kd"]), lim=arr(c["lim"]),
            period=cfg.control_period,
        )

    motor_map = _MOTOR_MAP_NED if cfg.orn_conv == "NED_FRD" else _MOTOR_MAP_ENU
    return QuadXParams(
        mass=jnp.asarray(frame["mass"], dtype=dt),
        inertia=jnp.asarray(frame["inertia"], dtype=dt),
        collision_half_extents=jnp.asarray(frame["collision_half_extents"], dtype=dt),
        motor=motor,
        motor_map=jnp.asarray(motor_map, dtype=dt),
        drag_const_xyz=jnp.full(
            (3,), 0.5 * 1.225 * dp["drag_coef_xyz"] * dp["drag_area_xyz"], dtype=dt
        ),
        drag_coef_pqr=jnp.asarray(dp["drag_coef_pqr"], dtype=dt),
        pid_ang_vel=bank("ang_vel"),
        pid_ang_pos=bank("ang_pos"),
        pid_lin_vel=bank("lin_vel"),
        pid_lin_pos=bank("lin_pos"),
        pid_z_pos=bank("z_pos"),
        pid_z_vel=bank("z_vel"),
    )


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@struct.dataclass
class QuadXPIDState:
    ang_vel: pid.PIDState  # (..., 3)
    ang_pos: pid.PIDState  # (..., 3)
    lin_vel: pid.PIDState  # (..., 2)
    lin_pos: pid.PIDState  # (..., 2)
    z_pos: pid.PIDState  # (..., 1)
    z_vel: pid.PIDState  # (..., 1)


@struct.dataclass
class QuadXRead:
    """The lagged 'sensor' snapshot consumed by control/physics/observations."""

    view: Array  # (..., 4, 3) [ang_vel, ang_pos, lin_vel, lin_pos] in orn_conv
    ang_vel_body: Array  # (..., 3) ENU body rates (for pqr pseudo-drag)
    drag_local_vel: Array  # (..., 3) body-frame air-relative velocity


@struct.dataclass
class QuadXState:
    body: Body6DoF  # actual integrator state (world ENU)
    read: QuadXRead  # one-physics-step-lagged snapshot
    throttle: Array  # (..., 4)
    pwm: Array  # (..., 4)
    setpoint: Array  # (..., 4)
    pids: QuadXPIDState
    contact: Array  # (...,) bool — contacts after the last integration
    physics_steps: Array  # (...,) int32


def init_pids(params: QuadXParams, batch_shape: tuple[int, ...] = ()) -> QuadXPIDState:
    mk = lambda p: pid.init(p, batch_shape)
    return QuadXPIDState(
        ang_vel=mk(params.pid_ang_vel),
        ang_pos=mk(params.pid_ang_pos),
        lin_vel=mk(params.pid_lin_vel),
        lin_pos=mk(params.pid_lin_pos),
        z_pos=mk(params.pid_z_pos),
        z_vel=mk(params.pid_z_vel),
    )


def update_state(
    body: Body6DoF, cfg: QuadXConfig, wind_vel: Array | None = None
) -> QuadXRead:
    """Computes the read snapshot from the raw body state (quadx.py:583-633)."""
    R = pm.quat_to_rotmat(body.quat)  # body->world
    lin_vel_b = jnp.einsum("...ji,...j->...i", R, body.lin_vel, precision="highest")
    ang_vel_b = jnp.einsum("...ji,...j->...i", R, body.ang_vel, precision="highest")
    euler = pm.quat_to_euler(body.quat)

    if cfg.orn_conv == "NED_FRD":
        lin_pos = pm.enu_pos_to_ned(body.pos)
        ang_pos = pm.enu_euler_to_ned(euler)
        lin_vel = pm.flu_vec_to_frd(lin_vel_b)
        ang_vel = pm.flu_vec_to_frd(ang_vel_b)
    else:
        lin_pos, ang_pos, lin_vel, ang_vel = body.pos, euler, lin_vel_b, ang_vel_b

    view = jnp.stack([ang_vel, ang_pos, lin_vel, lin_pos], axis=-2)

    air_vel = body.lin_vel if wind_vel is None else body.lin_vel - wind_vel
    drag_local_vel = jnp.einsum("...ji,...j->...i", R, air_vel, precision="highest")
    return QuadXRead(view=view, ang_vel_body=ang_vel_b, drag_local_vel=drag_local_vel)


def init_state(
    params: QuadXParams,
    cfg: QuadXConfig,
    start_pos: Array,
    start_orn: Array,
    wind_vel: Array | None = None,
) -> QuadXState:
    """Builds the reset state (reference reset: quadx.py:243-252).

    ``start_pos``/``start_orn`` are in the configured orientation convention
    (the reference converts NED spawns to ENU at base_drone.py:114-124);
    leading batch dims are allowed.
    """
    start_pos = jnp.asarray(start_pos, dtype=cfg.dtype)
    start_orn = jnp.asarray(start_orn, dtype=cfg.dtype)
    if cfg.orn_conv == "NED_FRD":
        pos_enu = pm.ned_pos_to_enu(start_pos)
        orn_enu = pm.ned_euler_to_enu(start_orn)
    else:
        pos_enu, orn_enu = start_pos, start_orn
    batch = start_pos.shape[:-1]
    body = Body6DoF(
        pos=pos_enu,
        quat=pm.euler_to_quat(orn_enu),
        lin_vel=jnp.zeros_like(pos_enu),
        ang_vel=jnp.zeros_like(pos_enu),
    )
    z4 = jnp.zeros((*batch, 4), dtype=cfg.dtype)
    return QuadXState(
        body=body,
        read=update_state(body, cfg, wind_vel),
        throttle=z4,
        pwm=z4,
        setpoint=z4,
        pids=init_pids(params, batch),
        contact=jnp.zeros(batch, dtype=bool),
        physics_steps=jnp.zeros(batch, dtype=jnp.int32),
    )


def mode_default_setpoint(state: QuadXState, mode: int, cfg: QuadXConfig) -> Array:
    """Setpoint preset applied on mode change (quadx.py:296-311)."""
    view = state.read.view
    batch = view.shape[:-2]
    z4 = jnp.zeros((*batch, 4), dtype=view.dtype)
    if mode == 0:
        return z4.at[..., 3].set(-1.0)
    if mode in (1, 5, 6):
        return z4
    if mode == 7:
        return jnp.stack(
            [view[..., 3, 0], view[..., 3, 1], view[..., 1, 2], view[..., 3, 2]],
            axis=-1,
        )
    if mode in (-1, 8, 9, 10):
        return state.setpoint  # reference leaves the setpoint untouched
    return z4.at[..., 3].set(view[..., 3, 2])


def set_mode(state: QuadXState, mode: int, cfg: QuadXConfig) -> QuadXState:
    """Resets PIDs and applies the mode's default setpoint."""
    pids = jax.tree.map(jnp.zeros_like, state.pids)
    return state.replace(setpoint=mode_default_setpoint(state, mode, cfg), pids=pids)


# ---------------------------------------------------------------------------
# control cascade
# ---------------------------------------------------------------------------


def _pid_lanes(
    st: pid.PIDState, pp: pid.PIDParams, meas: Array, setp: Array, n: int
) -> tuple[pid.PIDState, Array]:
    """Steps a PID on the first ``n`` lanes, preserving the rest of the state."""
    sub = pid.PIDState(st.integral[..., :n], st.prev_error[..., :n])
    sub_p = pid.PIDParams(
        kp=pp.kp[..., :n], ki=pp.ki[..., :n], kd=pp.kd[..., :n], lim=pp.lim[..., :n],
        period=pp.period,
    )
    new_sub, out = pid.step(sub, sub_p, meas, setp)
    return (
        pid.PIDState(
            st.integral.at[..., :n].set(new_sub.integral),
            st.prev_error.at[..., :n].set(new_sub.prev_error),
        ),
        out,
    )


def _yaw_frame(view: Array, xy: Array) -> Array:
    """Rotates a ground-frame xy command into the yaw frame (quadx.py:483-486)."""
    yaw = view[..., 1, 2]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.stack(
        [c * xy[..., 0] + s * xy[..., 1], -s * xy[..., 0] + c * xy[..., 1]], axis=-1
    )


def update_control(
    state: QuadXState,
    params: QuadXParams,
    cfg: QuadXConfig,
    mode: int,
    custom_controller=None,
) -> QuadXState:
    """Runs the mode's controller cascade; returns state with new pwm + PIDs.

    Mirrors quadx.py:419-561. ``mode`` is static (trace-time) — environments
    fix the flight mode, so XLA compiles only the needed branch. NOTE on the
    reference's NED_FRD modes 4/5/6: quadx.py:473/490 collapses ``a_output``
    to 2 elements, which crashes downstream; we implement the evident intent
    ([a1, -a0] on the xy lanes, yaw preserved).

    ``custom_controller``: optional ``(..., 4, 3) view, setpoint -> setpoint``
    pure function applied before the cascade — the functional form of the
    reference's registered ``ControlClass`` controllers, whose output becomes
    the setpoint for the registered base mode (quadx.py:433-444,
    base_drone.py:265-285). Pass the base mode as ``mode``.
    """
    view = state.read.view
    sp = state.setpoint
    if custom_controller is not None:
        sp = custom_controller(view, sp)
    a = sp[..., :3]
    z = sp[..., 3]
    pids = state.pids
    ned = cfg.orn_conv == "NED_FRD"

    if mode == -1:
        # raw PWM passthrough: the reference returns BEFORE the saturation
        # block for mode -1 (quadx.py:446-448), so no rescale and no clamp
        return state.replace(pwm=sp, pids=pids)
    if mode == 8:
        pwm = sp
    elif mode == 9:
        pwm = jnp.einsum("ij,...j->...i", params.motor_map, sp, precision="highest")
    elif mode == 10:
        cmd = ga_pid_step(view, sp)
        pwm = jnp.einsum("ij,...j->...i", params.motor_map, cmd, precision="highest")
    else:
        # ------ attitude cascade
        if mode in (0, 2):
            pids_av, a = pid.step(pids.ang_vel, params.pid_ang_vel, view[..., 0, :], a)
            pids = pids.replace(ang_vel=pids_av)
        elif mode in (1, 3):
            pids_ap, a = pid.step(pids.ang_pos, params.pid_ang_pos, view[..., 1, :], a)
            pids_av, a = pid.step(pids.ang_vel, params.pid_ang_vel, view[..., 0, :], a)
            pids = pids.replace(ang_pos=pids_ap, ang_vel=pids_av)
        elif mode in (4, 5, 6, 7):
            xy = a[..., :2]
            yaw_cmd = a[..., 2]
            if mode == 7:
                pids_lp, xy = pid.step(
                    pids.lin_pos, params.pid_lin_pos, view[..., 3, :2], xy
                )
                pids = pids.replace(lin_pos=pids_lp)
            if mode in (6, 7):
                xy = _yaw_frame(view, xy)
            pids_lv, xy = pid.step(pids.lin_vel, params.pid_lin_vel, view[..., 2, :2], xy)
            pids = pids.replace(lin_vel=pids_lv)
            # velocity command -> attitude command axis swap (quadx.py:472-515)
            if ned:
                xy = jnp.stack([xy[..., 1], -xy[..., 0]], axis=-1)
            else:
                xy = jnp.stack([-xy[..., 1], xy[..., 0]], axis=-1)
            if mode == 7:
                a3 = jnp.concatenate([xy, yaw_cmd[..., None]], axis=-1)
                pids_ap, a3 = pid.step(
                    pids.ang_pos, params.pid_ang_pos, view[..., 1, :], a3
                )
                pids = pids.replace(ang_pos=pids_ap)
                a = a3
            else:
                pids_ap, xy = _pid_lanes(
                    pids.ang_pos, params.pid_ang_pos, view[..., 1, :2], xy, 2
                )
                pids = pids.replace(ang_pos=pids_ap)
                a = jnp.concatenate([xy, yaw_cmd[..., None]], axis=-1)
            pids_av, a = pid.step(pids.ang_vel, params.pid_ang_vel, view[..., 0, :], a)
            pids = pids.replace(ang_vel=pids_av)

        # ------ height cascade (quadx.py:519-545)
        if mode == 0:
            z = jnp.clip(z, -1.0, 0.0) if ned else jnp.clip(z, 0.0, 1.0)
        elif mode in (1, 5, 6):
            pids_zv, z1 = pid.step(
                pids.z_vel, params.pid_z_vel, view[..., 2, 2:3], z[..., None]
            )
            pids = pids.replace(z_vel=pids_zv)
            z = z1[..., 0]
            z = jnp.clip(z, -1.0, 0.0) if ned else jnp.clip(z, 0.0, 1.0)
        elif mode in (2, 3, 4, 7):
            pids_zp, z1 = pid.step(
                pids.z_pos, params.pid_z_pos, view[..., 3, 2:3], z[..., None]
            )
            pids_zv, z1 = pid.step(pids.z_vel, params.pid_z_vel, view[..., 2, 2:3], z1)
            pids = pids.replace(z_pos=pids_zp, z_vel=pids_zv)
            z = z1[..., 0]
        if ned:
            z = -z
        z = jnp.clip(z, 0.0, 1.0)

        cmd = jnp.concatenate([a, z[..., None]], axis=-1)
        pwm = jnp.einsum("ij,...j->...i", params.motor_map, cmd, precision="highest")

    pwm = saturation_rescale(pwm, cfg.min_pwm, cfg.max_pwm)
    return state.replace(pwm=pwm, pids=pids)


def saturation_rescale(pwm: Array, min_pwm: float, max_pwm: float) -> Array:
    """Motor saturation handling preserving command shape (quadx.py:553-561)."""
    high = jnp.max(pwm, axis=-1, keepdims=True)
    low = jnp.min(pwm, axis=-1, keepdims=True)
    pwm_max = jnp.minimum(high, max_pwm)
    pwm_min = jnp.maximum(low, min_pwm)

    def safe_div(n, d):
        return jnp.where(d != 0.0, n / jnp.where(d == 0.0, 1.0, d), 0.0)

    add = safe_div(pwm_min - low, pwm_max - low) * (pwm_max - pwm)
    sub = safe_div(high - pwm_max, high - pwm_min) * (pwm - pwm_min)
    rescaled = jnp.where(high != low, pwm + add - sub, pwm)
    return jnp.clip(rescaled, min_pwm, max_pwm)


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------


def _wrench(
    read: QuadXRead, throttle: Array, contact: Array, params: QuadXParams
) -> tuple[Array, Array]:
    """Total body-frame (force, torque): motors + body drag + pqr pseudo-drag."""
    f_mot, t_mot = motors.wrench(throttle, params.motor)
    # quadratic body drag at the CoM (quadx.py:174-182; boring_bodies.py:110-124)
    v = read.drag_local_vel
    f_drag = -jnp.sign(v) * params.drag_const_xyz * v * v
    # rotational pseudo-drag, skipped while in contact (quadx.py:569-581);
    # the NED remap at :576-577 cancels (odd function), so ENU rates suffice.
    w = read.ang_vel_body
    t_pqr = -jnp.sign(w) * params.drag_coef_pqr * w * w
    t_pqr = jnp.where(contact[..., None], 0.0, t_pqr)
    return f_mot + f_drag, t_mot + t_pqr


def _contact_geom(params: QuadXParams) -> integrator.ContactGeom:
    h = params.collision_half_extents
    corners = jnp.stack(
        [
            jnp.asarray([sx, sy, sz], dtype=h.dtype) * h
            for sx in (-1.0, 1.0)
            for sy in (-1.0, 1.0)
            for sz in (-1.0, 1.0)
        ]
    )
    return integrator.ContactGeom(points=corners)


def physics_iter(
    state: QuadXState,
    params: QuadXParams,
    cfg: QuadXConfig,
    key: Array | None,
    wind_vel: Array | None = None,
) -> QuadXState:
    """One 240 Hz physics iteration (control NOT included — see ``step``)."""
    # update_physics: motor lag + noise, then the full wrench (quadx.py:563-581)
    throttle = motors.throttle_update(
        state.throttle,
        state.pwm,
        params.motor,
        cfg.physics_period,
        key if cfg.noisy_motors else None,
    )
    force_b, torque_b = _wrench(state.read, throttle, state.contact, params)

    # update_state BEFORE integrating: one-physics-step sensor latency
    new_read = update_state(state.body, cfg, wind_vel)

    rb = integrator.RigidBodyParams(mass=params.mass, inertia=params.inertia)
    body = integrator.step(state.body, rb, force_b, torque_b, cfg.physics_period)
    body, contact = integrator.ground_contact(body, rb, _contact_geom(params))

    return state.replace(
        body=body,
        read=new_read,
        throttle=throttle,
        contact=contact,
        physics_steps=state.physics_steps + 1,
    )


def step(
    state: QuadXState,
    params: QuadXParams,
    cfg: QuadXConfig,
    mode: int,
    key: Array | None = None,
    wind_fn=None,
    custom_controller=None,
) -> tuple[QuadXState, Array]:
    """One Aviary.step equivalent: ``physics_control_ratio`` physics iters with
    the controller gated at iteration 0 (aviary.py:478-500, single drone).

    Returns ``(state, any_contact)`` where ``any_contact`` accumulates contact
    over the step's physics iterations, mirroring the Aviary's per-step
    contact_array reset + splice (aviary.py:475, 493-496).
    """
    any_contact = jnp.zeros_like(state.contact)
    for s in range(cfg.physics_control_ratio):
        if s % cfg.physics_control_ratio == 0:
            state = update_control(state, params, cfg, mode, custom_controller)
        if key is not None:
            key, sub = jax.random.split(key)
        else:
            sub = None
        wind_vel = None
        if wind_fn is not None:
            # WindFn protocol (core/wind.py): (physics_step, ENU position)
            wind_vel = wind_fn(state.physics_steps, state.body.pos)
        state = physics_iter(state, params, cfg, sub, wind_vel)
        any_contact = any_contact | state.contact
    return state, any_contact
