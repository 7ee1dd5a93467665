"""Batched 6-DoF semi-implicit Euler integrator with ground contact.

Replaces the PyBullet backend of the reference (stepSimulation at
/root/reference/PyFlyt/core/aviary.py:491). PyBullet loads vehicles as
Featherstone multibodies whose forward dynamics include the gyroscopic
(ω × Iω) term; integration is semi-implicit Euler (velocities first, then
positions) at 240 Hz. We reproduce that scheme for a single floating rigid
body per vehicle (the reference's vehicles are rigid assemblies of massless
links around one inertial base, e.g. cf2x.urdf).

Everything is shape-polymorphic over leading batch dims and pure, so the whole
fleet integrates in one fused XLA program.
"""

from __future__ import annotations

import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.core.state import Body6DoF

GRAVITY = 9.81  # m/s^2, world -z (aviary.py:176 setGravity(0, 0, -9.81))


def _solve3x3(A: Array, b: Array) -> Array:
    """x = A⁻¹ b for batched symmetric 3×3 systems via the adjugate."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / det
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [
            (c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
            (c10 * b0 + c11 * b1 + c12 * b2) * inv_det,
            (c20 * b0 + c21 * b1 + c22 * b2) * inv_det,
        ],
        axis=-1,
    )


@struct.dataclass
class RigidBodyParams:
    """Inertial parameters. Batched fields broadcast against the state.

    ``inertia`` is the body-frame inertia about the center of mass: a
    ``(..., 3)`` diagonal by default, or a full ``(..., 3, 3)`` tensor when
    ``full_inertia`` is set (multibody composites assembled from URDF point
    masses have off-diagonal terms — see models/fixedwing.py).
    """

    mass: Array  # (...,) or scalar
    inertia: Array  # (..., 3) diagonal or (..., 3, 3) full body-frame inertia
    full_inertia: bool = struct.field(pytree_node=False, default=False)

    def inertia_diag(self) -> Array:
        """The (..., 3) diagonal (exact for diagonal params, the tensor
        diagonal otherwise — used by the approximate contact model)."""
        if self.full_inertia:
            return jnp.diagonal(self.inertia, axis1=-2, axis2=-1)
        return self.inertia


def step(
    body: Body6DoF,
    params: RigidBodyParams,
    force_body: Array,
    torque_body: Array,
    dt: float,
    force_world: Array | None = None,
) -> Body6DoF:
    """One semi-implicit Euler step under body-frame wrench + gravity.

    Args:
        body: current rigid-body state.
        params: mass/inertia (may be time-varying, e.g. rocket fuel burn).
        force_body: (..., 3) total external force in the body frame
            (PyBullet LINK_FRAME application, motors.py:148-151).
        torque_body: (..., 3) total external torque in the body frame.
        dt: physics period (1/240 s by default).
        force_world: optional (..., 3) extra world-frame force.

    Returns:
        The integrated state.
    """
    mass = jnp.asarray(params.mass)[..., None]
    inertia = params.inertia
    R = pm.quat_to_rotmat(body.quat)

    # --- linear: v' = v + dt (g + R f_b / m [+ f_w / m])
    force_w = jnp.einsum("...ij,...j->...i", R, force_body, precision="highest")
    if force_world is not None:
        force_w = force_w + force_world
    accel = force_w / mass
    accel = accel - jnp.asarray([0.0, 0.0, GRAVITY], dtype=body.pos.dtype)
    lin_vel = body.lin_vel + dt * accel

    # --- angular (body frame Euler equations, incl. gyroscopic term):
    # ω̇_b = I⁻¹ (τ_b − ω_b × I ω_b)
    omega_b = jnp.einsum("...ji,...j->...i", R, body.ang_vel, precision="highest")  # R^T ω_w
    if params.full_inertia:
        I_omega = jnp.einsum("...ij,...j->...i", inertia, omega_b, precision="highest")
        gyro = jnp.cross(omega_b, I_omega)
        # closed-form 3x3 inverse (adjugate/det): batched linalg.solve on
        # tiny matrices lowers to scalarized LU and dominates the rocket's
        # step time; the explicit form vectorizes on the VPU
        omega_b_dot = _solve3x3(inertia, torque_body - gyro)
    else:
        gyro = jnp.cross(omega_b, inertia * omega_b)
        omega_b_dot = (torque_body - gyro) / inertia
    omega_b_new = omega_b + dt * omega_b_dot
    ang_vel = jnp.einsum("...ij,...j->...i", R, omega_b_new, precision="highest")

    # --- positions last (semi-implicit)
    pos = body.pos + dt * lin_vel
    quat = pm.quat_integrate(body.quat, ang_vel, dt)

    return Body6DoF(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel)


# ---------------------------------------------------------------------------
# ground contact
# ---------------------------------------------------------------------------
# The reference gets contacts from PyBullet's solver and exposes them only as
# a boolean contact matrix (aviary.py:493-496); task envs terminate on any
# contact except landing tasks which must rest on a pad
# (rocket_landing_env.py:229-258). We therefore implement a cheap
# impulse-style point-contact model against the z=0 plane: enough to detect
# touches, kill bounces, and let a vehicle rest.


@struct.dataclass
class ContactGeom:
    """Collision sample points of the vehicle in the body frame."""

    points: Array  # (n_pts, 3) body-frame contact sample points
    friction: float = struct.field(pytree_node=False, default=0.5)
    restitution: float = struct.field(pytree_node=False, default=0.0)


def ground_contact(
    body: Body6DoF,
    params: RigidBodyParams,
    geom: ContactGeom,
    ground_z: float | Array = 0.0,
    per_point_iters: int | None = None,
) -> tuple[Body6DoF, Array]:
    """Detects and resolves contact of body-frame sample points with z=ground_z.

    Default (``per_point_iters=None``): sequential-impulse-lite — one batched
    pass of normal + friction impulses at the depth-weighted centroid, plus
    positional projection. Returns (state, contact?).

    ``per_point_iters=k`` instead runs ``k`` Gauss-Seidel sweeps applying an
    impulse at EVERY penetrating point — better multi-point resting dynamics
    at ~``k * n_pts`` times the impulse cost. Opt-in: the vehicle fast paths
    (and the rocket Pallas kernel, which mirrors the default's math
    in-register) keep the centroid model.

    Divergence vs MuJoCo's contact solver, measured on the recorded
    golden traces (tests/fixtures/mujoco_contact_*.npz, float32, 2 s):

    ================================  ===============  ==================
    scenario                          centroid model   per-point (k=4)
    ================================  ===============  ==================
    4-feet drop + settle (quadx)      1.2 cm max pos   1.7 cm max pos
    slide to rest under friction      1.1 cm, BUT a    0.7 cm, residual
                                      2 rad/s residual spin 0.2 rad/s
                                      spin (no spin
                                      damping from a
                                      single centroid
                                      impulse)
    tilted powered touchdown          1.0 cm pos, but  1.1 cm pos,
                                      0.42 settle-     0.011 settle-
                                      attitude error   attitude error
    rocket 3-leg touchdown (2 m/s)    17.5 cm max pos  13.2 cm max pos
                                      (rocking phase   (same rocking
                                      offset)          character)
    ================================  ===============  ==================

    The centroid artifacts only surface AFTER contact; every quadx/fixedwing
    task terminates on contact (gym_envs/..: term on ground hit), so the
    reward-bearing exposure is the Rocket-Landing settle
    (rocket_landing_env.py:229-258), where the two models agree to ~4 cm.
    tests/test_mujoco_parity.py asserts these bounds for both modes.
    """
    if per_point_iters is not None:
        return _ground_contact_per_point(
            body, params, geom, ground_z, per_point_iters
        )
    R = pm.quat_to_rotmat(body.quat)
    # world positions of contact points: (..., n, 3)
    pts_w = body.pos[..., None, :] + jnp.einsum("...ij,...nj->...ni", R, geom.points, precision="highest")
    depth = ground_z - pts_w[..., 2]  # >0 means penetrating
    contact = jnp.any(depth > 0.0, axis=-1)

    # the impulse acts at the depth-weighted centroid of penetrating points
    # (stable flat resting; coincides with the deepest point for single-corner
    # contact)
    w = jnp.maximum(depth, 0.0)
    w_sum = jnp.sum(w, axis=-1, keepdims=True)
    w_norm = w / jnp.maximum(w_sum, 1e-12)
    r_w = jnp.sum(
        (pts_w - body.pos[..., None, :]) * w_norm[..., None], axis=-2
    )
    max_depth = jnp.max(depth, axis=-1)

    mass = jnp.asarray(params.mass)
    inertia_w_inv = 1.0 / jnp.einsum(
        "...ij,...j->...i", R * R, params.inertia_diag()
    , precision="highest")  # approx: diag of R I R^T inverse (exact for near-axis-aligned)

    # point velocity
    v_pt = body.lin_vel + jnp.cross(body.ang_vel, r_w)

    # --- normal impulse (zero downward normal velocity, restitution bounce)
    n = jnp.asarray([0.0, 0.0, 1.0], dtype=body.pos.dtype)
    v_n = v_pt[..., 2]
    # effective mass along normal at the contact point
    rxn = jnp.cross(r_w, n)
    k_n = 1.0 / mass + jnp.sum(rxn * rxn * inertia_w_inv, axis=-1)
    j_n = jnp.maximum(-(1.0 + geom.restitution) * v_n / k_n, 0.0)
    j_n = jnp.where(contact & (v_n < 0.0), j_n, 0.0)
    impulse = j_n[..., None] * n

    # --- friction impulse (Coulomb clamp against tangential point velocity)
    v_t = v_pt * jnp.asarray([1.0, 1.0, 0.0], dtype=body.pos.dtype)
    # pm.safe_norm: the tangential velocity is exactly 0 for a body at rest,
    # where linalg.norm's cotangent is NaN and would poison BPTT through the
    # whole airborne trajectory (the where-mask below does not block it)
    v_t_norm = pm.safe_norm(v_t, keepdims=True)
    t_dir = v_t / jnp.maximum(v_t_norm, 1e-9)
    rxt = jnp.cross(r_w, t_dir)
    k_t = 1.0 / mass + jnp.sum(rxt * rxt * inertia_w_inv, axis=-1)
    j_t = jnp.minimum(v_t_norm[..., 0] / k_t, geom.friction * j_n)
    impulse = impulse - jnp.where(contact[..., None], j_t[..., None] * t_dir, 0.0)

    lin_vel = body.lin_vel + impulse / mass[..., None]
    ang_vel = body.ang_vel + jnp.cross(r_w, impulse) * inertia_w_inv

    # --- positional projection: lift the body out of the ground
    pos = body.pos + jnp.where(
        contact[..., None],
        jnp.stack(
            [
                jnp.zeros_like(max_depth),
                jnp.zeros_like(max_depth),
                jnp.maximum(max_depth, 0.0),
            ],
            axis=-1,
        ),
        0.0,
    )

    lin_vel = jnp.where(contact[..., None], lin_vel, body.lin_vel)
    ang_vel = jnp.where(contact[..., None], ang_vel, body.ang_vel)

    return Body6DoF(pos=pos, quat=body.quat, lin_vel=lin_vel, ang_vel=ang_vel), contact


def _ground_contact_per_point(
    body: Body6DoF,
    params: RigidBodyParams,
    geom: ContactGeom,
    ground_z: float | Array,
    n_iter: int,
) -> tuple[Body6DoF, Array]:
    """Gauss-Seidel sweeps of per-point normal+friction impulses (see
    ground_contact). The point set and penetration mask are frozen at the
    pre-resolution pose (the standard one-shot manifold of impulse solvers);
    the unrolled point loop is trace-time static, so XLA sees straight-line
    vector code with no gathers."""
    R = pm.quat_to_rotmat(body.quat)
    pts_w = body.pos[..., None, :] + jnp.einsum(
        "...ij,...nj->...ni", R, geom.points
    , precision="highest")
    depth = ground_z - pts_w[..., 2]
    pen = depth > 0.0
    contact = jnp.any(pen, axis=-1)
    max_depth = jnp.max(depth, axis=-1)

    mass = jnp.asarray(params.mass)
    inertia_w_inv = 1.0 / jnp.einsum(
        "...ij,...j->...i", R * R, params.inertia_diag()
    , precision="highest")
    n = jnp.asarray([0.0, 0.0, 1.0], dtype=body.pos.dtype)
    xy = jnp.asarray([1.0, 1.0, 0.0], dtype=body.pos.dtype)

    lin_vel, ang_vel = body.lin_vel, body.ang_vel
    n_pts = geom.points.shape[-2]
    for _ in range(n_iter):
        for i in range(n_pts):
            r_w = pts_w[..., i, :] - body.pos
            active = pen[..., i]
            v_pt = lin_vel + jnp.cross(ang_vel, r_w)
            v_n = v_pt[..., 2]
            rxn = jnp.cross(r_w, n)
            k_n = 1.0 / mass + jnp.sum(rxn * rxn * inertia_w_inv, axis=-1)
            j_n = jnp.maximum(-(1.0 + geom.restitution) * v_n / k_n, 0.0)
            j_n = jnp.where(active & (v_n < 0.0), j_n, 0.0)
            impulse = j_n[..., None] * n

            v_t = v_pt * xy
            v_t_norm = pm.safe_norm(v_t, keepdims=True)  # grad-safe at rest
            t_dir = v_t / jnp.maximum(v_t_norm, 1e-9)
            rxt = jnp.cross(r_w, t_dir)
            k_t = 1.0 / mass + jnp.sum(rxt * rxt * inertia_w_inv, axis=-1)
            j_t = jnp.minimum(v_t_norm[..., 0] / k_t, geom.friction * j_n)
            impulse = impulse - jnp.where(
                active[..., None], j_t[..., None] * t_dir, 0.0
            )

            lin_vel = lin_vel + impulse / mass[..., None]
            ang_vel = ang_vel + jnp.cross(r_w, impulse) * inertia_w_inv

    pos = body.pos + jnp.where(
        contact[..., None],
        jnp.stack(
            [
                jnp.zeros_like(max_depth),
                jnp.zeros_like(max_depth),
                jnp.maximum(max_depth, 0.0),
            ],
            axis=-1,
        ),
        0.0,
    )
    lin_vel = jnp.where(contact[..., None], lin_vel, body.lin_vel)
    ang_vel = jnp.where(contact[..., None], ang_vel, body.ang_vel)
    return (
        Body6DoF(pos=pos, quat=body.quat, lin_vel=lin_vel, ang_vel=ang_vel),
        contact,
    )
