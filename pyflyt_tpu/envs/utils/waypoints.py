"""Fixed-shape functional waypoint handler.

Re-implements /root/reference/PyFlyt/gym_envs/utils/waypoint_handler.py with
jit-compatible static shapes: instead of popping targets off a Python list
(waypoint_handler.py:161-183), targets live in a fixed ``(num_targets, 3)``
buffer with an int32 cursor ``idx``; "remaining" targets are the suffix from
the cursor. All distances/advancement become masked array ops, so the whole
handler batches under ``vmap`` and runs inside the env's scanned inner loop.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm


@struct.dataclass
class WaypointState:
    targets: Array  # (n, 3) sampled waypoint positions
    yaw_targets: Array  # (n,) sampled yaw targets (zeros if unused)
    idx: Array  # int32 cursor: index of the current target
    old_distance: Array  # scalar: previous distance to the current target
    new_distance: Array  # scalar: latest distance to the current target
    yaw_error: Array  # scalar: |yaw error| to the current target


@dataclasses.dataclass(frozen=True)
class WaypointHandler:
    """Static configuration + pure helpers (waypoint_handler.py:16-195)."""

    num_targets: int = 4
    use_yaw_targets: bool = False
    goal_reach_distance: float = 0.2
    goal_reach_angle: float = 0.1
    flight_dome_size: float = 5.0
    min_height: float = 0.1

    @property
    def delta_size(self) -> int:
        return 4 if self.use_yaw_targets else 3

    def reset(self, key: Array, dtype=jnp.float32) -> WaypointState:
        """Polar-coordinate target sampling (waypoint_handler.py:66-83):
        θ, φ ~ U(0, 2π), dist ~ U(1, 0.9·dome), z = |d cosφ| floored at 0.1."""
        k_theta, k_phi, k_dist, k_yaw = jax.random.split(key, 4)
        n = self.num_targets
        theta = jax.random.uniform(k_theta, (n,), dtype, 0.0, 2.0 * jnp.pi)
        phi = jax.random.uniform(k_phi, (n,), dtype, 0.0, 2.0 * jnp.pi)
        dist = jax.random.uniform(
            k_dist, (n,), dtype, 1.0, 0.9 * self.flight_dome_size
        )
        x = dist * jnp.sin(phi) * jnp.cos(theta)
        y = dist * jnp.sin(phi) * jnp.sin(theta)
        z = jnp.abs(dist * jnp.cos(phi))
        z = jnp.where(z > self.min_height, z, self.min_height)
        targets = jnp.stack([x, y, z], axis=-1)
        yaw_targets = jax.random.uniform(k_yaw, (n,), dtype, -jnp.pi, jnp.pi)
        if not self.use_yaw_targets:
            yaw_targets = jnp.zeros_like(yaw_targets)
        zero = jnp.zeros((), dtype)
        return WaypointState(
            targets=targets,
            yaw_targets=yaw_targets,
            idx=jnp.zeros((), jnp.int32),
            old_distance=zero,
            new_distance=zero,
            yaw_error=zero,
        )

    def update_distances(
        self, ws: WaypointState, ang_pos: Array, lin_pos: Array, quat: Array
    ) -> tuple[WaypointState, Array]:
        """``distance_to_target`` (waypoint_handler.py:105-142).

        Returns ``(state, deltas)`` where ``deltas`` is the full
        ``(num_targets, 3|4)`` body-frame target-delta buffer in *original*
        target order (use :meth:`remaining_deltas` for the reference's
        remaining-targets view). Updates old/new distance to the current
        target and the yaw error scalar.
        """
        # matmul((targets - lin_pos), R_body2world) == world→body rotation
        R = pm.quat_to_rotmat(quat)
        deltas = jnp.einsum("...nj,...ji->...ni", ws.targets - lin_pos[..., None, :], R)
        if self.use_yaw_targets:
            yaw_err = pm.wrap_angle(ws.yaw_targets - ang_pos[..., 2:3])
            deltas = jnp.concatenate([deltas, yaw_err[..., None]], axis=-1)
            yaw_error = jnp.abs(
                jnp.take_along_axis(yaw_err, ws.idx[..., None], axis=-1)[..., 0]
            )
        else:
            yaw_error = ws.yaw_error
        current = jnp.take_along_axis(
            deltas[..., :3], ws.idx[..., None, None], axis=-2
        )[..., 0, :]
        new_distance = jnp.linalg.norm(current, axis=-1)
        ws = ws.replace(
            old_distance=ws.new_distance, new_distance=new_distance, yaw_error=yaw_error
        )
        return ws, deltas

    def remaining_deltas(self, ws: WaypointState, deltas: Array) -> Array:
        """The reference's variable-length remaining-target view as a fixed
        ``(num_targets, 3|4)`` array: rolled so the current target is row 0,
        rows past the remaining count zeroed (Sequence space → zero-padding)."""
        rolled = jnp.roll(deltas, -ws.idx, axis=-2)
        n = deltas.shape[-2]
        remaining = n - ws.idx
        mask = jnp.arange(n) < remaining
        return jnp.where(mask[..., None], rolled, 0.0)

    def immediate_distance(self, ws: WaypointState, deltas: Array) -> Array:
        """``norm(target_deltas[0])`` over the full 3/4-dim delta
        (quadx_waypoints_env.py:157-159 — includes the yaw component)."""
        current = jnp.take_along_axis(
            deltas, ws.idx[..., None, None], axis=-2
        )[..., 0, :]
        return jnp.linalg.norm(current, axis=-1)

    def progress_to_target(self, ws: WaypointState) -> Array:
        return ws.old_distance - ws.new_distance

    def target_reached(self, ws: WaypointState) -> Array:
        reached = ws.new_distance < self.goal_reach_distance
        if self.use_yaw_targets:
            reached = reached & (ws.yaw_error < self.goal_reach_angle)
        return reached

    def advance_targets(self, ws: WaypointState) -> WaypointState:
        """Bumps the cursor (the reference pops the list head,
        waypoint_handler.py:161-172)."""
        return ws.replace(idx=jnp.minimum(ws.idx + 1, self.num_targets))

    def num_targets_reached(self, ws: WaypointState) -> Array:
        return ws.idx

    def all_targets_reached(self, ws: WaypointState) -> Array:
        return ws.idx >= self.num_targets

    def marker_boxes(self, ws: WaypointState):
        """Waypoint markers for third-person renders (gym_wrapper.render).

        The reference loads one target.urdf per waypoint scaled to
        goal_reach_distance/4 and colors them green fading darker with list
        position, deleting each marker as it is reached
        (waypoint_handler.py:85-103, 172-183). Here: one box per target,
        color (0, 1 - i/n, 0, 1) by ORIGINAL index, hidden once passed.
        """
        from pyflyt_tpu.core import camera as cam

        n = self.num_targets
        order = jnp.arange(n)
        half = self.goal_reach_distance / 4.0
        colors = jnp.stack(
            [
                jnp.zeros(n),
                1.0 - order / n,
                jnp.zeros(n),
                jnp.ones(n),
            ],
            axis=-1,
        )
        return cam.Boxes(
            centers=ws.targets,
            half_extents=jnp.full((n, 3), half),
            rotations=jnp.broadcast_to(jnp.eye(3), (n, 3, 3)),
            colors=colors,
            visible=order >= ws.idx,
        )
