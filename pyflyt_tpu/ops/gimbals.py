"""Two-axis servo gimbals (Rodrigues rotations about arbitrary unit vectors).

Re-implements /root/reference/PyFlyt/core/abstractions/gimbals.py as a pure
batched op: first-order actuation lag, then the rotation-about-axis matrices
``R = I + sin(θ)·W + 2 sin²(θ/2)·W²`` (gimbals.py:173-211) composed per
gimbal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array


def _skew(units: np.ndarray) -> np.ndarray:
    """(n, 3) axis vectors -> (n, 3, 3) skew matrices (gimbals.py:93-111)."""
    w = np.zeros((units.shape[0], 3, 3))
    w[:, 2, 1] = units[:, 0]
    w[:, 1, 2] = -units[:, 0]
    w[:, 0, 2] = units[:, 1]
    w[:, 2, 0] = -units[:, 1]
    w[:, 1, 0] = units[:, 2]
    w[:, 0, 1] = -units[:, 2]
    return w


@struct.dataclass
class GimbalParams:
    w1: Array  # (n, 3, 3)
    w2: Array  # (n, 3, 3)
    w1_squared: Array  # (n, 3, 3)
    w2_squared: Array  # (n, 3, 3)
    tau: Array  # (n,)
    range_radians: Array  # (n, 2)


def build(
    gimbal_unit_1: np.ndarray,
    gimbal_unit_2: np.ndarray,
    gimbal_tau: np.ndarray,
    gimbal_range_degrees: np.ndarray,
    dtype=jnp.float32,
) -> GimbalParams:
    u1 = np.asarray(gimbal_unit_1, dtype=np.float64)
    u2 = np.asarray(gimbal_unit_2, dtype=np.float64)
    u1 = u1 / np.linalg.norm(u1, axis=-1, keepdims=True)
    u2 = u2 / np.linalg.norm(u2, axis=-1, keepdims=True)
    w1, w2 = _skew(u1), _skew(u2)
    return GimbalParams(
        w1=jnp.asarray(w1, dtype=dtype),
        w2=jnp.asarray(w2, dtype=dtype),
        w1_squared=jnp.asarray(w1 @ w1, dtype=dtype),
        w2_squared=jnp.asarray(w2 @ w2, dtype=dtype),
        tau=jnp.asarray(gimbal_tau, dtype=dtype),
        range_radians=jnp.asarray(np.deg2rad(gimbal_range_degrees), dtype=dtype),
    )


def init(params: GimbalParams, batch_shape: tuple[int, ...] = (), dtype=jnp.float32) -> Array:
    """Zero gimbal state of shape (..., n, 2) (gimbals.py:115-119)."""
    n = params.tau.shape[-1]
    return jnp.zeros((*batch_shape, n, 2), dtype)


def compute_rotation(
    gimbal_state: Array, cmd: Array, params: GimbalParams, physics_period: float
) -> tuple[Array, Array]:
    """First-order lag + composed axis rotations (gimbals.py:141-211).

    Args:
        gimbal_state: (..., n, 2) current normalized deflections.
        cmd: (..., n, 2) commands in [-1, 1].

    Returns:
        (new_state, rotation) with rotation (..., n, 3, 3).
    """
    # the reference asserts cmd ∈ [-1, 1] (gimbals.py:147-149); the
    # jit-compatible equivalent is a clip, so out-of-range commands cannot
    # rotate the thrust beyond the physical gimbal range
    cmd = jnp.clip(cmd, -1.0, 1.0)
    state = gimbal_state + (physics_period / params.tau[..., None]) * (
        cmd - gimbal_state
    )
    angles = state * params.range_radians  # (..., n, 2)
    a1 = angles[..., 0, None, None]
    a2 = angles[..., 1, None, None]
    eye = jnp.eye(3, dtype=state.dtype)
    r1 = eye + jnp.sin(a1) * params.w1 + 2.0 * jnp.sin(a1 / 2.0) ** 2 * params.w1_squared
    r2 = eye + jnp.sin(a2) * params.w2 + 2.0 * jnp.sin(a2 / 2.0) ** 2 * params.w2_squared
    return state, jnp.matmul(r1, r2, precision="highest")
