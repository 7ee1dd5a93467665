"""Propeller motor array: first-order throttle lag + quadratic thrust/torque.

Re-implements /root/reference/PyFlyt/core/abstractions/motors.py:108-191 as a
pure batched op. Differences from the reference are structural only:

- instead of ``applyExternalForce/Torque`` per motor link (a Python→C++ call
  per motor per step), we return the summed body-frame wrench; thrust offsets
  (the motor link positions from the URDF) contribute ``r × F`` torque.
- motor noise draws from a stateless JAX PRNG key rather than the global
  ``np.random.RandomState`` stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array


@struct.dataclass
class MotorParams:
    """Static parameters for n motors. All per-motor arrays have shape (n,...)."""

    positions: Array  # (n, 3) body-frame thrust application points (URDF link pos)
    thrust_unit: Array  # (n, 3) unit thrust directions in body frame
    thrust_coef: Array  # (n,)
    torque_coef: Array  # (n,) signed: right-hand rule around thrust_unit
    tau: Array  # (n,) first-order ramp time constant
    max_rpm: Array  # (n,)
    noise_ratio: Array  # (n,)


def throttle_update(
    throttle: Array,
    pwm: Array,
    params: MotorParams,
    physics_period: float,
    key: Array | None = None,
) -> Array:
    """First-order lag + multiplicative Gaussian noise (motors.py:126-134)."""
    throttle = throttle + (physics_period / params.tau) * (pwm - throttle)
    if key is not None:
        noise = jax.random.normal(key, jnp.shape(throttle), dtype=throttle.dtype)
        throttle = throttle + noise * throttle * params.noise_ratio
    return throttle


def wrench(throttle: Array, params: MotorParams) -> tuple[Array, Array]:
    """Body-frame (force, torque) totals from per-motor throttle.

    Per motor (motors.py:176-191): ``rpm = throttle·max_rpm``;
    ``F = rpm²·sign(rpm)·unit·Ct``; ``τ_axis = rpm²·sign(rpm)·unit·Cq``;
    plus the lever-arm torque ``r × F`` that PyBullet got implicitly from
    applying each force at its motor link.
    """
    rpm = throttle * params.max_rpm
    rpm_const = (rpm * rpm) * jnp.sign(rpm)  # (..., n)
    thrust = rpm_const[..., None] * params.thrust_unit * params.thrust_coef[..., None]
    axis_torque = (
        rpm_const[..., None] * params.thrust_unit * params.torque_coef[..., None]
    )
    lever_torque = jnp.cross(params.positions, thrust)
    force_total = jnp.sum(thrust, axis=-2)
    torque_total = jnp.sum(axis_torque + lever_torque, axis=-2)
    return force_total, torque_total
