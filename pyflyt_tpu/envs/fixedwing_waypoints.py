"""Fixedwing Waypoints task.

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/fixedwing_envs/fixedwing_waypoints_env.py:
spawn at z=10 with 20 m/s forward velocity, fly through waypoints in a 100 m
dome over 120 s episodes. Reward per inner step (:154-173):
``+max(3·progress, 0) + 1.0/dist``, 100 on reach.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.fixedwing_base import FixedwingBaseEnv, FixedwingEnvState
from pyflyt_tpu.envs.utils.waypoints import WaypointHandler, WaypointState


@struct.dataclass
class FixedwingWaypointsState(FixedwingEnvState):
    wp: WaypointState
    target_deltas: Array  # (num_targets, 3)


@dataclasses.dataclass(frozen=True)
class FixedwingWaypointsEnv(FixedwingBaseEnv):
    sparse_reward: bool = False
    num_targets: int = 4
    goal_reach_distance: float = 2.0
    flight_dome_size: float = 100.0
    max_duration_seconds: float = 120.0
    agent_hz: int = 30
    start_pos: tuple = ((0.0, 0.0, 10.0),)

    @property
    def waypoints(self) -> WaypointHandler:
        return WaypointHandler(
            num_targets=self.num_targets,
            use_yaw_targets=False,
            goal_reach_distance=self.goal_reach_distance,
            goal_reach_angle=float("inf"),
            flight_dome_size=self.flight_dome_size,
        )

    def scene_boxes(self, state: FixedwingWaypointsState):
        """Waypoint markers with the reference's fading colors
        (waypoint_handler.py:85-103) for gym_wrapper.render."""
        return self.waypoints.marker_boxes(state.wp)

    @property
    def obs_size(self) -> int:
        return self.combined_size

    def observation_space_factory(self, spaces):
        import numpy as np

        return spaces.Dict(
            {
                "attitude": spaces.Box(
                    low=-np.inf, high=np.inf, shape=(self.combined_size,),
                    dtype=np.float64,
                ),
                "target_deltas": spaces.Box(
                    low=-2 * self.flight_dome_size,
                    high=2 * self.flight_dome_size,
                    shape=(self.num_targets, 3),
                    dtype=np.float64,
                ),
            }
        )

    def _obs(self, state: FixedwingWaypointsState) -> dict:
        return {
            "attitude": self.attitude_obs(state),
            "target_deltas": state.target_deltas,
        }

    def reset(self, key: Array) -> tuple[FixedwingWaypointsState, dict]:
        base = self.init_env_state(key)
        wp_key = jax.random.fold_in(base.key, 7)
        ws = self.waypoints.reset(wp_key, dtype=self.cfg.dtype)
        view = base.drone.read.view
        ws, deltas = self.waypoints.update_distances(
            ws, view[..., 1, :], view[..., 3, :], pm.euler_to_quat(view[..., 1, :])
        )
        state = FixedwingWaypointsState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            wp=ws,
            target_deltas=self.waypoints.remaining_deltas(ws, deltas),
        )
        return state, self._obs(state)

    def _task_update(
        self, state: FixedwingWaypointsState, contact: Array
    ) -> FixedwingWaypointsState:
        wph = self.waypoints
        view = state.drone.read.view
        ang_pos, lin_pos = view[..., 1, :], view[..., 3, :]
        ws, deltas = wph.update_distances(
            state.wp, ang_pos, lin_pos, pm.euler_to_quat(ang_pos)
        )
        state = state.replace(
            wp=ws, target_deltas=wph.remaining_deltas(ws, deltas)
        )

        state = self.base_term_trunc_reward(state, contact)
        reward = state.reward
        if not self.sparse_reward:
            reward = reward + jnp.maximum(3.0 * wph.progress_to_target(ws), 0.0)
            reward = reward + 1.0 / wph.immediate_distance(ws, deltas)

        reached = wph.target_reached(ws)
        reward = jnp.where(reached, 100.0, reward)
        ws = jax.tree.map(
            lambda a, b: jnp.where(reached, a, b), wph.advance_targets(ws), ws
        )
        all_reached = wph.all_targets_reached(ws)
        return state.replace(
            wp=ws,
            reward=reward,
            truncation=state.truncation | all_reached,
            env_complete=state.env_complete | all_reached,
        )

    def step(
        self, state: FixedwingWaypointsState, action: Array
    ) -> tuple[FixedwingWaypointsState, StepOut]:
        return self.base_step(
            state,
            action,
            self._task_update,
            self._obs,
            extra_info=lambda s: {"num_targets_reached": s.wp.idx},
        )
