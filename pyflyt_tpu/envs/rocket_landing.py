"""Rocket Landing task.

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/rocket_envs/rocket_landing_env.py: drop from
~450 m at −100 m/s with 1% fuel and land upright on a 2 m-radius pad.

Reward per inner step (:193-219): −5 loiter penalty + 2/(pad offset+0.1)
+ 100·xy-progress − |yaw rate| − 3·‖tilt‖; +20 on pad touch; fatal if
touchdown with ‖ω‖>0.35 or ‖v‖>1.0 (one-step-lagged velocities);
**+500 landed** when ‖ω‖<0.02, ‖v‖<0.02 and upright (:229-258).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.rocket_base import RocketBaseEnv, RocketEnvState


@struct.dataclass
class RocketLandingState(RocketEnvState):
    pad_position: Array  # (3,)
    pad_contact_flag: Array  # scalar float (obs field)
    ang_vel: Array  # (3,) current body rates (compute_state cache)
    lin_vel: Array  # (3,)
    distance: Array  # (3,) lin_pos - pad_position
    prev_ang_vel: Array
    prev_lin_vel: Array
    prev_distance: Array


@dataclasses.dataclass(frozen=True)
class RocketLandingEnv(RocketBaseEnv):
    sparse_reward: bool = False
    ceiling: float = 500.0
    max_displacement: float = 200.0
    max_duration_seconds: float = 30.0
    agent_hz: int = 40

    @property
    def obs_size(self) -> int:
        # combined + pad contact flag + rotated pad-relative distance
        return self.combined_size + 1 + 3

    def _obs(self, state: RocketLandingState) -> Array:
        view = state.drone.read.view
        rotation = pm.quat_to_rotmat(pm.euler_to_quat(view[..., 1, :]))
        rotated_distance = jnp.einsum(
            "...j,...ji->...i", state.distance, rotation
        , precision="highest")
        return jnp.concatenate(
            [
                self.attitude_obs(state),
                state.pad_contact_flag[..., None],
                rotated_distance,
            ],
            axis=-1,
        )

    def reset(self, key: Array) -> tuple[RocketLandingState, Array]:
        """Random polar pad placement (rocket_landing_env.py:111-121) then the
        base drop reset."""
        key, k_theta, k_dist = jax.random.split(key, 3)
        dtype = self.cfg.dtype
        theta = jax.random.uniform(k_theta, (), dtype, 0.0, 2.0 * jnp.pi)
        dist = jax.random.uniform(k_dist, (), dtype, 0.0, 0.05 * self.ceiling)
        pad_position = (
            jnp.stack([jnp.cos(theta), jnp.sin(theta), jnp.asarray(0.1, dtype)])
            * dist
        )

        base = self.init_env_state(key, pad_position)
        view = base.drone.read.view
        zero3 = jnp.zeros(3, dtype=dtype)
        state = RocketLandingState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            pad_position=pad_position,
            pad_contact_flag=jnp.zeros((), dtype=dtype),
            ang_vel=zero3,
            lin_vel=zero3,
            distance=zero3,
            prev_ang_vel=zero3,
            prev_lin_vel=zero3,
            prev_distance=zero3,
        )
        state = self._compute_state_fields(state)
        return state, self._obs(state)

    def _compute_state_fields(self, state: RocketLandingState) -> RocketLandingState:
        """compute_state (rocket_landing_env.py:137-156): shift previous
        values, refresh current readouts + pad-relative distance."""
        view = state.drone.read.view
        return state.replace(
            prev_ang_vel=state.ang_vel,
            prev_lin_vel=state.lin_vel,
            prev_distance=state.distance,
            ang_vel=view[..., 0, :],
            lin_vel=view[..., 2, :],
            distance=view[..., 3, :] - state.pad_position,
        )

    def _task_update(
        self, state: RocketLandingState, ground_contact: Array, pad_contact: Array
    ) -> RocketLandingState:
        state = self._compute_state_fields(state)
        view = state.drone.read.view
        ang_pos = view[..., 1, :]

        # fatal contact excludes the landing pad (collision_ignore_mask,
        # rocket_landing_env.py:188-190) — ground_contact is already pad-free
        state = self.base_term_trunc(state, ground_contact)

        reward = state.reward
        if not self.sparse_reward:
            progress_to_pad = jnp.linalg.norm(
                state.prev_distance[..., :2], axis=-1
            ) - jnp.linalg.norm(state.distance[..., :2], axis=-1)
            offset_to_pad = jnp.linalg.norm(state.distance[..., :2], axis=-1) + 0.1
            reward = reward + (
                -5.0
                + (2.0 / offset_to_pad)
                + (100.0 * progress_to_pad)
                - jnp.abs(state.ang_vel[..., 2])
                - 3.0 * jnp.linalg.norm(ang_pos[..., :2], axis=-1)
            )

        # pad touchdown logic (rocket_landing_env.py:229-258)
        reward = jnp.where(pad_contact, reward + 20.0, reward)
        pad_flag = jnp.where(pad_contact, 1.0, 0.0).astype(reward.dtype)

        hard = (jnp.linalg.norm(state.prev_ang_vel, axis=-1) > 0.35) | (
            jnp.linalg.norm(state.prev_lin_vel, axis=-1) > 1.0
        )
        landed = (
            (jnp.linalg.norm(state.prev_ang_vel, axis=-1) < 0.02)
            & (jnp.linalg.norm(state.prev_lin_vel, axis=-1) < 0.02)
            & (jnp.linalg.norm(ang_pos[..., :2], axis=-1) < 0.1)
        )
        fatal_touch = pad_contact & hard
        complete = pad_contact & ~hard & landed
        reward = jnp.where(complete, reward + 500.0, reward)
        return state.replace(
            reward=reward,
            pad_contact_flag=pad_flag,
            termination=state.termination | fatal_touch | complete,
            fatal_collision=state.fatal_collision | fatal_touch,
            env_complete=state.env_complete | complete,
        )

    def scene_boxes(self, state: RocketLandingState):
        """The landing pad for third-person renders (box-approximated
        cylinder, landing_pad.urdf: r=2, l=0.1)."""
        from pyflyt_tpu.core import camera as cam

        return cam.Boxes(
            centers=state.pad_position[None, :],
            half_extents=jnp.asarray([[2.0, 2.0, 0.05]]),
            rotations=jnp.eye(3)[None],
            colors=jnp.asarray([[0.2, 0.2, 0.8, 1.0]]),
            visible=jnp.ones((1,), bool),
        )

    def step(
        self, state: RocketLandingState, action: Array
    ) -> tuple[RocketLandingState, StepOut]:
        return self.base_step(
            state,
            action,
            self._task_update,
            self._obs,
            pad_position=state.pad_position,
        )
