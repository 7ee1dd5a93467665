"""State pytrees for the batched flight-dynamics core.

The reference keeps per-drone mutable Python objects (PyBullet bodies +
component instances — /root/reference/PyFlyt/core/abstractions/base_drone.py).
Here every vehicle is a slice of a struct-of-arrays pytree so that one jitted
program steps the whole fleet/batch.

Frame conventions (see core/math.py):
- ``pos``      world ENU position of the base link
- ``quat``     body→world rotation, xyzw
- ``lin_vel``  world-frame linear velocity
- ``ang_vel``  world-frame angular velocity (PyBullet's getBaseVelocity frame)

``read_*`` fields implement the reference's one-physics-step sensor latency:
in Aviary.step the per-drone ``update_state`` runs *before* ``stepSimulation``
(/root/reference/PyFlyt/core/aviary.py:487-491), so controllers and
observations always see the state from before the most recent integration.
"""

from __future__ import annotations

from pyflyt_tpu.core import struct
from jax import Array


@struct.dataclass
class Body6DoF:
    """Rigid-body state integrated by the 6-DoF integrator."""

    pos: Array  # (..., 3) world ENU
    quat: Array  # (..., 4) xyzw, body -> world
    lin_vel: Array  # (..., 3) world frame
    ang_vel: Array  # (..., 3) world frame


@struct.dataclass
class DroneStateView:
    """The reference's (4, 3) drone state readout, unpacked.

    Mirrors /root/reference/PyFlyt/core/aviary.py:338-353:
      state[0] body-frame angular velocity
      state[1] ground-frame euler angles
      state[2] body-frame linear velocity
      state[3] ground-frame position
    already remapped to the orientation convention (ENU_FLU or NED_FRD).
    """

    ang_vel: Array  # (..., 3)
    ang_pos: Array  # (..., 3)
    lin_vel: Array  # (..., 3)
    lin_pos: Array  # (..., 3)
