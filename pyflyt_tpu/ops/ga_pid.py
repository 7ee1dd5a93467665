"""Gain-scheduled state-feedback controller (fork feature, QuadX mode 10).

Re-implements /root/reference/PyFlyt/core/abstractions/ga_pid.py as a pure
function: ``u = -K(x - x_ss) + u_ss`` with K selected from four hardcoded
4x12 gain matrices by the current yaw quadrant, outputs reordered to RPYT.
Stateless (the reference's function-attribute "static" K is always
reassigned before use, so it carries no information across calls).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

from pyflyt_tpu.core.math import wrap_angle

_USS = np.array([0.365, 0.0, 0.0, 0.0], dtype=np.float32)

# gain matrices over state ordering [lin_pos(3), ang_pos(3), lin_vel(3), ang_vel(3)]
# rows: [thrust, roll, pitch, yaw]; indexed by yaw quadrant (ga_pid.py:5-43)
_K = np.zeros((4, 4, 12), dtype=np.float32)
# common rows for all quadrants
for i in range(4):
    _K[i, 0, 2] = -0.05
    _K[i, 0, 8] = -0.08
    _K[i, 1, 3] = 0.2
    _K[i, 1, 7] = 0.04
    _K[i, 1, 9] = 0.01
    _K[i, 2, 4] = 0.2
    _K[i, 2, 6] = -0.04
    _K[i, 2, 10] = 0.01
    _K[i, 3, 5] = 0.07
    _K[i, 3, 11] = 0.08
# quadrant-dependent position-error coupling into roll/pitch
# quadrant 0: yaw in [-45, 45] deg
_K[0, 1, 1] = 0.02
_K[0, 2, 0] = -0.02
# quadrant 1: yaw in (45, 135]
_K[1, 1, 0] = -0.02
_K[1, 2, 1] = -0.02
# quadrant 2: yaw in [-135, -45)
_K[2, 1, 0] = 0.02
_K[2, 2, 1] = 0.02
# quadrant 3: |yaw| > 135
_K[3, 1, 1] = -0.02
_K[3, 2, 0] = 0.02

_QUARTER = 0.785398  # ~45 deg, constant used by the reference (ga_pid.py:71-78)


def ga_pid_step(state: Array, setpoint: Array) -> Array:
    """Computes the RPYT command from drone state and [x, y, psi, z] setpoint.

    Args:
        state: (..., 4, 3) drone state [ang_vel, ang_pos, lin_vel, lin_pos]
            (NED_FRD convention in the fork's usage).
        setpoint: (..., 4) [x, y, psi, z] target.

    Returns:
        (..., 4) RPYT command for the motor mixer.
    """
    ang_vel = state[..., 0, :]
    ang_pos = wrap_angle(state[..., 1, :])
    lin_vel = state[..., 2, :]
    lin_pos = state[..., 3, :]
    # x ordering: [lin_pos, ang_pos, lin_vel, ang_vel] (ga_pid.py:62)
    x = jnp.concatenate([lin_pos, ang_pos, lin_vel, ang_vel], axis=-1)

    psi_sp = wrap_angle(setpoint[..., 2])
    # xss places [x, y, z] at rows 0-2 and psi at row 5 (ga_pid.py:67-70)
    xss = jnp.zeros_like(x)
    xss = xss.at[..., 0].set(setpoint[..., 0])
    xss = xss.at[..., 1].set(setpoint[..., 1])
    xss = xss.at[..., 2].set(setpoint[..., 3])
    xss = xss.at[..., 5].set(psi_sp)

    yaw = ang_pos[..., 2]
    quadrant = jnp.where(
        (yaw >= -_QUARTER) & (yaw <= _QUARTER),
        0,
        jnp.where(
            (yaw > _QUARTER) & (yaw <= 3 * _QUARTER),
            1,
            jnp.where((yaw < -_QUARTER) & (yaw >= -3 * _QUARTER), 2, 3),
        ),
    )
    k = jnp.asarray(_K, dtype=x.dtype)[quadrant]  # (..., 4, 12)

    error = x - xss
    out = -jnp.einsum("...ij,...j->...i", k, error, precision="highest") + jnp.asarray(_USS, dtype=x.dtype)
    # reorder [T, roll, pitch, yaw] -> RPYT (ga_pid.py:85)
    return jnp.stack([out[..., 1], out[..., 2], out[..., 3], out[..., 0]], axis=-1)
