"""Batched lifting-surface aerodynamics (Khan et al. agile fixed-wing model).

Re-implements /root/reference/PyFlyt/core/abstractions/lifting_surfaces.py as
pure array ops over a stacked surface axis: one call computes every surface of
every vehicle in the batch. The reference's per-surface numba kernels
(:315-484) become vectorized ``jnp.where`` branches (no-stall linear regime vs
post-stall flat-plate), so XLA fuses the whole aero stack into the physics
step.

Structural differences from the reference (physics preserved):
- forces are returned as one body-frame wrench about the vehicle CoM (the
  reference applies per-link external forces in PyBullet; the lever-arm torque
  ``r × F`` reproduces that effect),
- per-surface local velocities are computed by the caller from the rigid-body
  state (the reference reads ``getLinkStates`` — lifting_surfaces.py:75-104).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm

HALF_RHO = 0.5 * 1.225  # lifting_surfaces.py:224


@struct.dataclass
class SurfaceParams:
    """Static parameters for n stacked lifting surfaces.

    Derived fields (area/aspect/Cl_alpha_3D/theta_f/aero_tau) are precomputed
    in :func:`build` exactly as the reference ctor does
    (lifting_surfaces.py:219-231).
    """

    positions: Array  # (n, 3) body-frame application points (URDF link origins)
    lift_unit: Array  # (n, 3)
    drag_unit: Array  # (n, 3) forward/travel direction
    torque_unit: Array  # (n, 3) = lift × forward
    chord: Array  # (n,)
    span: Array  # (n,)
    area: Array  # (n,)
    aspect: Array  # (n,)
    flap_to_chord: Array  # (n,)
    eta: Array  # (n,)
    alpha_0_base: Array  # (n,) radians
    alpha_stall_P_base: Array  # (n,) radians
    alpha_stall_N_base: Array  # (n,) radians
    Cl_alpha_3D: Array  # (n,)
    Cd_0: Array  # (n,)
    deflection_limit: Array  # (n,) degrees
    aero_tau: Array  # (n,) flap effectiveness
    tau: Array  # (n,) actuation ramp time constant


def build(surface_dicts: list[dict], dtype=jnp.float32) -> SurfaceParams:
    """Assembles stacked params from per-surface YAML dicts (each carrying
    position/lifting_unit/forward_unit plus the Khan-model coefficients)."""

    def col(key):
        return np.asarray([s[key] for s in surface_dicts], dtype=np.float64)

    lift_unit = col("lifting_unit")
    fwd_unit = col("forward_unit")
    lift_unit = lift_unit / np.linalg.norm(lift_unit, axis=-1, keepdims=True)
    fwd_unit = fwd_unit / np.linalg.norm(fwd_unit, axis=-1, keepdims=True)
    chord = col("chord")
    span = col("span")
    aspect = span / chord
    cl2d = col("Cl_alpha_2D")
    cl3d = cl2d * (aspect / (aspect + ((2.0 * (aspect + 4.0)) / (aspect + 2.0))))
    flap_to_chord = col("flap_to_chord")
    theta_f = np.arccos(2.0 * flap_to_chord - 1.0)
    aero_tau = 1.0 - ((theta_f - np.sin(theta_f)) / np.pi)
    a = lambda x: jnp.asarray(x, dtype=dtype)
    return SurfaceParams(
        positions=a(col("position")),
        lift_unit=a(lift_unit),
        drag_unit=a(fwd_unit),
        torque_unit=a(np.cross(lift_unit, fwd_unit)),
        chord=a(chord),
        span=a(span),
        area=a(chord * span),
        aspect=a(aspect),
        flap_to_chord=a(flap_to_chord),
        eta=a(col("eta")),
        alpha_0_base=a(np.deg2rad(col("alpha_0_base"))),
        alpha_stall_P_base=a(np.deg2rad(col("alpha_stall_P_base"))),
        alpha_stall_N_base=a(np.deg2rad(col("alpha_stall_N_base"))),
        Cl_alpha_3D=a(cl3d),
        Cd_0=a(col("Cd_0")),
        deflection_limit=a(col("deflection_limit")),
        aero_tau=a(aero_tau),
        tau=a(col("tau")),
    )


def actuation_update(
    actuation: Array, cmd: Array, params: SurfaceParams, physics_period: float
) -> Array:
    """First-order flap deflection lag (lifting_surfaces.py:266)."""
    return actuation + (physics_period / params.tau) * (cmd - actuation)


def aoa_freestream(
    local_velocity: Array, params: SurfaceParams
) -> tuple[Array, Array]:
    """Angle of attack + freestream speed from body-frame surface velocity
    (lifting_surfaces.py:315-335)."""
    # grad-safe norm: zero airspeed (pre-launch rest) must not NaN-poison
    # gradients taken through the aero model (core/math.py safe_norm)
    freestream = pm.safe_norm(local_velocity)
    lifting = jnp.sum(local_velocity * params.lift_unit, axis=-1)
    forward = jnp.sum(local_velocity * params.drag_unit, axis=-1)
    alpha = jnp.arctan2(-lifting, forward)
    return alpha, freestream


def _interp(x, x0, x1, y0, y1):
    """np.interp over a single [x0, x1] segment with edge clamping."""
    t = jnp.clip((x - x0) / (x1 - x0), 0.0, 1.0)
    return y0 + t * (y1 - y0)


def aero_coefficients(
    alpha: Array, actuation: Array, params: SurfaceParams
) -> tuple[Array, Array, Array]:
    """(Cl, Cd, CM) with the no-stall linear regime and the post-stall
    flat-plate model (lifting_surfaces.py:337-435), fully vectorized."""
    p = params
    deflection = jnp.deg2rad(actuation * p.deflection_limit)

    delta_Cl = p.Cl_alpha_3D * p.aero_tau * p.eta * deflection
    delta_Cl_max = p.flap_to_chord * delta_Cl
    Cl_max_P = p.Cl_alpha_3D * (p.alpha_stall_P_base - p.alpha_0_base) + delta_Cl_max
    Cl_max_N = p.Cl_alpha_3D * (p.alpha_stall_N_base - p.alpha_0_base) + delta_Cl_max
    alpha_0 = p.alpha_0_base - (delta_Cl / p.Cl_alpha_3D)
    alpha_stall_P = alpha_0 + (Cl_max_P / p.Cl_alpha_3D)
    alpha_stall_N = alpha_0 + (Cl_max_N / p.Cl_alpha_3D)

    # ---- no-stall linear regime (lifting_surfaces.py:349-358)
    Cl_lin = p.Cl_alpha_3D * (alpha - alpha_0)
    alpha_i_lin = Cl_lin / (jnp.pi * p.aspect)
    ae_lin = alpha - alpha_0 - alpha_i_lin
    CT_lin = p.Cd_0 * jnp.cos(ae_lin)
    CN_lin = (Cl_lin + (CT_lin * jnp.sin(ae_lin))) / jnp.cos(ae_lin)
    Cd_lin = (CN_lin * jnp.sin(ae_lin)) + (CT_lin * jnp.cos(ae_lin))
    CM_lin = -CN_lin * (0.25 - (0.175 * (1.0 - ((2.0 * ae_lin) / jnp.pi))))

    # ---- post-stall flat-plate model (lifting_surfaces.py:360-435)
    Cl_stall_P = p.Cl_alpha_3D * (alpha_stall_P - alpha_0)
    Cl_stall_N = p.Cl_alpha_3D * (alpha_stall_N - alpha_0)
    ai_stall_P = Cl_stall_P / (jnp.pi * p.aspect)
    ai_stall_N = Cl_stall_N / (jnp.pi * p.aspect)
    alpha_i_pos = _interp(alpha, alpha_stall_P, jnp.pi / 2.0, ai_stall_P, 0.0)
    alpha_i_neg = _interp(alpha, -jnp.pi / 2.0, alpha_stall_N, 0.0, ai_stall_N)
    alpha_i_stall = jnp.where(alpha > 0.0, alpha_i_pos, alpha_i_neg)
    ae_st = alpha - alpha_0 - alpha_i_stall

    Cd_90 = (
        (-4.26e-2 * deflection * deflection) + (2.1e-1 * deflection) + 1.98
    )
    CN_st = (
        Cd_90
        * jnp.sin(ae_st)
        * (
            1.0 / (0.56 + 0.44 * jnp.abs(jnp.sin(ae_st)))
            - 0.41 * (1.0 - jnp.exp(-17.0 / p.aspect))
        )
    )
    CT_st = 0.5 * p.Cd_0 * jnp.cos(ae_st)
    Cl_st = (CN_st * jnp.cos(ae_st)) - (CT_st * jnp.sin(ae_st))
    Cd_st = (CN_st * jnp.sin(ae_st)) + (CT_st * jnp.cos(ae_st))
    CM_st = -CN_st * (0.25 - (0.175 * (1.0 - ((2.0 * jnp.abs(ae_st)) / jnp.pi))))

    no_stall = (alpha_stall_N < alpha) & (alpha < alpha_stall_P)
    Cl = jnp.where(no_stall, Cl_lin, Cl_st)
    Cd = jnp.where(no_stall, Cd_lin, Cd_st)
    CM = jnp.where(no_stall, CM_lin, CM_st)
    return Cl, Cd, CM


def wrench(
    actuation: Array,
    local_velocities: Array,
    params: SurfaceParams,
    com_offset: Array,
) -> tuple[Array, Array]:
    """Total body-frame (force, torque about the CoM) over all surfaces.

    Mirrors lifting_surfaces.py:437-484 per surface; the per-link PyBullet
    force application becomes lever-arm torque ``(r - r_com) × F``.

    Args:
        actuation: (..., n) current deflections.
        local_velocities: (..., n, 3) body-frame air-relative velocity at each
            surface.
        params: stacked surface parameters.
        com_offset: (3,) body-frame vector base-origin → CoM.
    """
    alpha, freestream = aoa_freestream(local_velocities, params)
    Cl, Cd, CM = aero_coefficients(alpha, actuation, params)

    Q_area = HALF_RHO * freestream * freestream * params.area
    lift = Cl * Q_area
    drag = Cd * Q_area
    force_normal = (lift * jnp.cos(alpha)) + (drag * jnp.sin(alpha))
    force_parallel = (lift * jnp.sin(alpha)) - (drag * jnp.cos(alpha))

    force = (
        params.lift_unit * force_normal[..., None]
        + params.drag_unit * force_parallel[..., None]
    )
    torque = (Q_area * CM * params.chord)[..., None] * params.torque_unit
    lever = jnp.cross(params.positions - com_offset[..., None, :], force)
    return jnp.sum(force, axis=-2), jnp.sum(torque + lever, axis=-2)
