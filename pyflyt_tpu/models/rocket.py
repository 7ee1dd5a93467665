"""Rocket (1:10 Falcon-9-like booster) vehicle model.

Batched-JAX re-implementation of /root/reference/PyFlyt/core/drones/rocket.py:
quadratic body drag + 4 grid-fin lifting surfaces + a fueled, gimballed
booster on a composite rigid body whose mass/CoM/inertia track the remaining
fuel each physics step (the reference mutates the fuel-tank link via
``changeDynamics`` — boosters.py:246-258; here the composite is recomputed
analytically, same quasi-static granularity).

Setpoint (7): [finlet x, finlet y, finlet yaw, ignition, throttle,
gimbal axis 1, gimbal axis 2] (rocket.py:19-27). Mode 0 only: the finlet mix
matrix maps setpoint[:3] to 4 finlet deflections (rocket.py:148-155, 240-247),
cmd = [4 finlets, ignition, throttle, gimbal1, gimbal2].
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
from pyflyt_tpu.ops import boosters, gimbals, lifting_surfaces


@dataclasses.dataclass(frozen=True)
class RocketConfig:
    drone_model: str = "rocket"
    control_hz: int = 120
    physics_hz: int = 240
    noisy_boosters: bool = True
    starting_fuel_ratio: float = 0.05  # rocket.py:45
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
class RocketParams:
    # dry-frame point masses/inertias (fuel handled separately)
    base_mass: Array
    base_inertia: Array  # (3,)
    base_position: Array  # (3,)
    booster_mass: Array
    booster_inertia: Array  # (3,)
    booster_position: Array  # (3,)
    fueltank_position: Array  # (3,)
    fin_mass: Array
    fin_positions: Array  # (4, 3)
    contact_points: Array  # (k, 3)
    drag_const: Array  # (3,) = ½ρ·Cd·A per axis
    drag_position: Array  # (3,) application point (link 0 = fueltank)
    finlets: lifting_surfaces.SurfaceParams
    booster: boosters.BoosterParams
    gimbal: gimbals.GimbalParams
    finlet_map: Array  # (4, 3)


def build_params(cfg: RocketConfig) -> RocketParams:
    y = load_vehicle_yaml(cfg.drone_model, cfg.model_dir)
    dt = cfg.dtype
    frame, bp, body, ctl = (
        y["frame"], y["booster_params"], y["body_params"], y["control_params"],
    )
    a = lambda v: jnp.asarray(v, dtype=dt)

    booster = boosters.BoosterParams(
        positions=a([frame["booster_position"]]),
        thrust_unit=a([bp["thrust_unit"]]),
        tau=a([bp["booster_tau"]]),
        total_fuel_mass=a([bp["total_fuel"]]),
        max_fuel_rate=a([bp["max_fuel_rate"]]),
        max_inertia=a([[bp["inertia_ixx"], bp["inertia_iyy"], bp["inertia_izz"]]]),
        min_thrust=a([bp["min_thrust"]]),
        max_thrust=a([bp["max_thrust"]]),
        reignitable=jnp.asarray([bp["reignitable"]], dtype=bool),
        noise_ratio=a([bp["noise_ratio"]]),
    )
    gimbal = gimbals.build(
        gimbal_unit_1=np.array([[1.0, 0.0, 0.0]]),
        gimbal_unit_2=np.array([[0.0, 1.0, 0.0]]),
        gimbal_tau=np.array([bp["gimbal_tau"]]),
        gimbal_range_degrees=np.array([[bp["gimbal_range_degrees"]] * 2]),
        dtype=dt,
    )
    return RocketParams(
        base_mass=a(frame["base_mass"]),
        base_inertia=a(frame["base_inertia"]),
        base_position=a(frame["base_position"]),
        booster_mass=a(frame["booster_mass"]),
        booster_inertia=a(frame["booster_inertia"]),
        booster_position=a(frame["booster_position"]),
        fueltank_position=a(frame["fueltank_position"]),
        fin_mass=a(frame["fin_mass"]),
        fin_positions=a(frame["fin_positions"]),
        contact_points=a(frame["contact_points"]),
        drag_const=a(
            [
                0.5 * 1.225 * body["drag_coef_x"] * body["area_x"],
                0.5 * 1.225 * body["drag_coef_y"] * body["area_y"],
                0.5 * 1.225 * body["drag_coef_z"] * body["area_z"],
            ]
        ),
        drag_position=a(frame["fueltank_position"]),  # BoringBodies body_ids=[0]
        finlets=lifting_surfaces.build(y["finlets"], dtype=dt),
        booster=booster,
        gimbal=gimbal,
        finlet_map=a(ctl["finlet_map"]),
    )


def mass_properties(
    params: RocketParams, fuel_mass: Array, fuel_inertia: Array
) -> tuple[Array, Array, Array]:
    """Composite (mass, com, inertia 3×3) for the current fuel load.

    Point-mass + link-inertia composition over [base, fueltank(fuel),
    booster, 4 fins] — what PyBullet's Featherstone recomputes after
    ``changeDynamics`` on the fuel tank.
    """
    fm = fuel_mass[..., 0]
    fi = fuel_inertia[..., 0, :]
    masses = [params.base_mass, fm, params.booster_mass] + [params.fin_mass] * 4
    positions = [
        params.base_position,
        params.fueltank_position,
        params.booster_position,
        *[params.fin_positions[i] for i in range(4)],
    ]
    inertias = [params.base_inertia, fi, params.booster_inertia] + [
        jnp.zeros(3, dtype=fi.dtype)
    ] * 4

    mass = sum(jnp.asarray(m) for m in masses)
    com = sum(jnp.asarray(m)[..., None] * p for m, p in zip(masses, positions))
    com = com / mass[..., None]

    eye = jnp.eye(3, dtype=com.dtype)
    inertia = jnp.zeros(com.shape[:-1] + (3, 3), dtype=com.dtype)
    for m, p, i_diag in zip(masses, positions, inertias):
        d = p - com
        m = jnp.asarray(m)
        shift = m[..., None, None] * (
            jnp.sum(d * d, axis=-1)[..., None, None] * eye
            - d[..., :, None] * d[..., None, :]
        )
        inertia = inertia + shift + i_diag[..., None] * eye
    return mass, com, inertia


NUM_FINLETS = 4


@struct.dataclass
class RocketRead:
    view: Array  # (..., 4, 3) base-origin readouts
    finlet_local_vel: Array  # (..., 4, 3)
    drag_local_vel: Array  # (..., 3) air velocity at the drag link, body frame


@struct.dataclass
class RocketState:
    body: Body6DoF  # CoM state (CoM of the *current* fuel load)
    read: RocketRead
    actuation: Array  # (..., 4) finlet deflections
    booster: boosters.BoosterState
    gimbal_state: Array  # (..., 1, 2)
    cmd: Array  # (..., 8)
    setpoint: Array  # (..., 7)
    contact: Array  # (...,) bool — any contact (ground or pad)
    ground_contact: Array  # (...,) bool — contact excluding the pad
    pad_contact: Array  # (...,) bool
    physics_steps: Array  # (...,) int32


def _com_kinematics(body: Body6DoF, com: Array):
    R = pm.quat_to_rotmat(body.quat)
    r = jnp.einsum("...ij,...j->...i", R, com, precision="highest")
    base_pos = body.pos - r
    base_vel = body.lin_vel + jnp.cross(body.ang_vel, -r)
    return R, base_pos, base_vel


def update_state(
    body: Body6DoF,
    params: RocketParams,
    cfg: RocketConfig,
    com: Array,
    physics_steps: Array,
    wind_fn=None,
) -> RocketRead:
    """Read snapshot (rocket.py:280-314 + surface/body state updates)."""
    R, base_pos, base_vel = _com_kinematics(body, com)
    lin_vel_b = jnp.einsum("...ji,...j->...i", R, base_vel, precision="highest")
    ang_vel_b = jnp.einsum("...ji,...j->...i", R, body.ang_vel, precision="highest")
    euler = pm.quat_to_euler(body.quat)
    view = jnp.stack([ang_vel_b, euler, lin_vel_b, base_pos], axis=-2)

    def local_vel_at(points: Array) -> Array:
        r = jnp.einsum("...ij,...nj->...ni", R, points - com[..., None, :], precision="highest")
        v = body.lin_vel[..., None, :] + jnp.cross(body.ang_vel[..., None, :], r)
        if wind_fn is not None:
            v = v - wind_fn(physics_steps, body.pos[..., None, :] + r)
        return jnp.einsum("...ji,...nj->...ni", R, v, precision="highest")

    finlet_local = local_vel_at(params.finlets.positions)
    drag_local = local_vel_at(params.drag_position[None, :])[..., 0, :]
    return RocketRead(
        view=view, finlet_local_vel=finlet_local, drag_local_vel=drag_local
    )


def init_state(
    params: RocketParams,
    cfg: RocketConfig,
    start_pos: Array,
    start_orn: Array,
    start_lin_vel: Array | None = None,
    start_ang_vel: Array | None = None,
) -> RocketState:
    """Reset (rocket.py:216-228): base origin at start_pos, fuel at
    ``cfg.starting_fuel_ratio``, optional initial velocities
    (rocket_base_env.py:204-221)."""
    start_pos = jnp.asarray(start_pos, dtype=cfg.dtype)
    start_orn = jnp.asarray(start_orn, dtype=cfg.dtype)
    batch = start_pos.shape[:-1]
    bst = boosters.init(
        params.booster, batch, cfg.starting_fuel_ratio, dtype=cfg.dtype
    )
    fuel_mass = bst.ratio_fuel_remaining * params.booster.total_fuel_mass
    fuel_inertia = (
        bst.ratio_fuel_remaining[..., None] * params.booster.max_inertia
    )
    _, com, _ = mass_properties(params, fuel_mass, fuel_inertia)

    quat = pm.euler_to_quat(start_orn)
    R = pm.quat_to_rotmat(quat)
    com_pos = start_pos + jnp.einsum("...ij,...j->...i", R, com, precision="highest")
    lin_vel = (
        jnp.zeros_like(start_pos)
        if start_lin_vel is None
        else jnp.asarray(start_lin_vel, dtype=cfg.dtype)
    )
    ang_vel = (
        jnp.zeros_like(start_pos)
        if start_ang_vel is None
        else jnp.asarray(start_ang_vel, dtype=cfg.dtype)
    )
    body = Body6DoF(pos=com_pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel)
    zeros = lambda *s: jnp.zeros((*batch, *s), dtype=cfg.dtype)
    return RocketState(
        body=body,
        read=update_state(body, params, cfg, com, jnp.zeros(batch, jnp.int32)),
        actuation=zeros(NUM_FINLETS),
        booster=bst,
        gimbal_state=zeros(1, 2),
        cmd=zeros(8),
        setpoint=zeros(7),
        contact=jnp.zeros(batch, dtype=bool),
        ground_contact=jnp.zeros(batch, dtype=bool),
        pad_contact=jnp.zeros(batch, dtype=bool),
        physics_steps=jnp.zeros(batch, dtype=jnp.int32),
    )


def update_control(
    state: RocketState, params: RocketParams, cfg: RocketConfig
) -> RocketState:
    """Finlet mix + passthrough (rocket.py:240-255, mode 0)."""
    finlet_cmd = jnp.clip(
        jnp.einsum("ij,...j->...i", params.finlet_map, state.setpoint[..., :3], precision="highest"),
        -1.0,
        1.0,
    )
    cmd = jnp.concatenate([finlet_cmd, state.setpoint[..., 3:]], axis=-1)
    return state.replace(cmd=cmd)


def _pad_ground_heights(
    pts_w: Array, pad_position: Array | None, pad_radius: float = 2.0,
    pad_half_height: float = 0.05,
) -> tuple[Array, Array]:
    """Per-point ground height: the landing pad is a raised disc
    (landing_pad.urdf: cylinder r=2, l=0.1). Returns (heights, on_pad)."""
    if pad_position is None:
        z = jnp.zeros(pts_w.shape[:-1], dtype=pts_w.dtype)
        return z, jnp.zeros(pts_w.shape[:-1], dtype=bool)
    d_xy = pts_w[..., :2] - pad_position[..., None, :2]
    on_pad = jnp.sum(d_xy * d_xy, axis=-1) < pad_radius**2
    pad_top = pad_position[..., 2] + pad_half_height
    heights = jnp.where(on_pad, pad_top[..., None], 0.0)
    return heights, on_pad


def physics_iter(
    state: RocketState,
    params: RocketParams,
    cfg: RocketConfig,
    key: Array | None,
    wind_fn=None,
    pad_position: Array | None = None,
) -> RocketState:
    """One 240 Hz physics iteration (rocket.py:257-275 update_physics)."""
    cmd = state.cmd

    # body drag at the drag link (boring_bodies.py:110-124)
    v = state.read.drag_local_vel
    f_drag = -jnp.sign(v) * params.drag_const * v * v
    t_drag = jnp.cross(
        params.drag_position - _current_com(state, params), f_drag
    )

    # finlets (aero at the quirky reference link positions)
    actuation = lifting_surfaces.actuation_update(
        state.actuation, cmd[..., :NUM_FINLETS], params.finlets, cfg.physics_period
    )
    f_fin, t_fin = lifting_surfaces.wrench(
        actuation,
        state.read.finlet_local_vel,
        params.finlets,
        _current_com(state, params),
    )

    # gimbal rotation then booster thrust (rocket.py:263-275)
    gimbal_cmd = jnp.stack([cmd[..., 6], cmd[..., 7]], axis=-1)[..., None, :]
    gimbal_state, rot = gimbals.compute_rotation(
        state.gimbal_state, gimbal_cmd, params.gimbal, cfg.physics_period
    )
    if key is not None:
        key, sub = jax.random.split(key)
    else:
        sub = None
    bst, thrust, fuel_mass, fuel_inertia = boosters.update(
        state.booster,
        params.booster,
        cmd[..., 4:5],
        jnp.clip(cmd[..., 5:6], 0.0, 1.0),
        cfg.physics_period,
        sub if cfg.noisy_boosters else None,
    )
    thrust_dir = jnp.einsum(
        "...nij,...nj->...ni", rot, params.booster.thrust_unit
    , precision="highest")
    f_boost_n = thrust[..., None] * thrust_dir  # (..., 1, 3)
    mass, com, inertia = mass_properties(params, fuel_mass, fuel_inertia)
    t_boost = jnp.cross(params.booster.positions - com[..., None, :], f_boost_n)
    f_boost = jnp.sum(f_boost_n, axis=-2)
    t_boost = jnp.sum(t_boost, axis=-2)

    new_read = update_state(
        state.body, params, cfg, com, state.physics_steps, wind_fn
    )

    rb = integrator.RigidBodyParams(mass=mass, inertia=inertia, full_inertia=True)
    body = integrator.step(
        state.body,
        rb,
        f_drag + f_fin + f_boost,
        t_drag + t_fin + t_boost,
        cfg.physics_period,
    )

    # contact against ground plane + raised landing pad
    R = pm.quat_to_rotmat(body.quat)
    pts_b = params.contact_points - com[..., None, :]
    pts_w = body.pos[..., None, :] + jnp.einsum("...ij,...nj->...ni", R, pts_b, precision="highest")
    heights, on_pad = _pad_ground_heights(pts_w, pad_position)
    penetrating = (heights - pts_w[..., 2]) > 0.0
    pad_contact = jnp.any(on_pad & penetrating, axis=-1)
    ground_only = jnp.any(~on_pad & penetrating, axis=-1)
    body, contact = integrator.ground_contact(
        body, rb, integrator.ContactGeom(points=pts_b), ground_z=heights
    )

    return state.replace(
        body=body,
        read=new_read,
        actuation=actuation,
        booster=bst,
        gimbal_state=gimbal_state,
        contact=contact,
        ground_contact=ground_only,
        pad_contact=pad_contact,
        physics_steps=state.physics_steps + 1,
    )


def _current_com(state: RocketState, params: RocketParams) -> Array:
    """CoM offset for the current fuel load (cheap recompute)."""
    fuel_mass = state.booster.ratio_fuel_remaining * params.booster.total_fuel_mass
    fuel_inertia = (
        state.booster.ratio_fuel_remaining[..., None] * params.booster.max_inertia
    )
    _, com, _ = mass_properties(params, fuel_mass, fuel_inertia)
    return com


def aux_state(state: RocketState) -> Array:
    """[finlet actuations (4), booster states (3), gimbal states (2)]
    (rocket.py:303-309) — 9 values."""
    return jnp.concatenate(
        [
            state.actuation,
            boosters.get_states(state.booster),
            state.gimbal_state.reshape(*state.gimbal_state.shape[:-2], -1),
        ],
        axis=-1,
    )


def step(
    state: RocketState,
    params: RocketParams,
    cfg: RocketConfig,
    key: Array | None = None,
    wind_fn=None,
    pad_position: Array | None = None,
) -> tuple[RocketState, Array, Array]:
    """One Aviary.step equivalent. Returns (state, any_ground_contact,
    any_pad_contact) accumulated over the step's physics iterations."""
    any_ground = jnp.zeros_like(state.ground_contact)
    any_pad = jnp.zeros_like(state.pad_contact)
    for s in range(cfg.physics_control_ratio):
        if s % cfg.physics_control_ratio == 0:
            state = update_control(state, params, cfg)
        if key is not None:
            key, sub = jax.random.split(key)
        else:
            sub = None
        state = physics_iter(state, params, cfg, sub, wind_fn, pad_position)
        any_ground = any_ground | state.ground_contact
        any_pad = any_pad | state.pad_contact
    return state, any_ground, any_pad
