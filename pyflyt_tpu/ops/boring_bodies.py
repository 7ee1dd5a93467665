"""Quadratic drag bodies ("boring bodies").

Re-implements /root/reference/PyFlyt/core/abstractions/boring_bodies.py:
``F = −sign(v_local) · ½ρ·Cd·A · v_local²`` per body-frame axis, where
``v_local`` is the body-frame air-relative velocity (link velocity minus wind,
rotated into the body frame — boring_bodies.py:76-124). The force acts at the
body's position; when the drag body sits at the vehicle CoM (the QuadX case,
quadx.py:174-182) it contributes no torque, otherwise ``r × F`` applies.
"""

from __future__ import annotations

import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array


@struct.dataclass
class BoringBodyParams:
    positions: Array  # (n, 3) body-frame positions of the drag bodies
    drag_const: Array  # (n, 3) = ½ · 1.225 · Cd · A per axis


def drag_wrench(
    local_velocities: Array, params: BoringBodyParams
) -> tuple[Array, Array]:
    """Body-frame (force, torque) from per-body local air-relative velocity.

    Args:
        local_velocities: (..., n, 3) body-frame air-relative velocity of each
            drag body (link velocity minus wind, rotated into body frame).
    """
    forces = -jnp.sign(local_velocities) * params.drag_const * local_velocities**2
    torque = jnp.sum(jnp.cross(params.positions, forces), axis=-2)
    return jnp.sum(forces, axis=-2), torque
