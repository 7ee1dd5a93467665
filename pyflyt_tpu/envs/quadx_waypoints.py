"""QuadX Waypoints task.

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/quadx_envs/quadx_waypoints_env.py: fly through
a sequence of random waypoints. Reward per inner aviary step (:160-179):
``+max(3·progress, 0) + 0.1/dist``, overwritten to 100 on target reach; the
episode truncates when all targets are reached.

Static-shape deviation from the reference: the Sequence observation space of
remaining target deltas becomes a fixed ``(num_targets, 3|4)`` array rolled so
the current target is row 0 and exhausted rows are zero (see
``WaypointHandler.remaining_deltas``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.quadx_base import QuadXBaseEnv, QuadXEnvState
from pyflyt_tpu.envs.utils.waypoints import WaypointHandler, WaypointState


@struct.dataclass
class QuadXWaypointsState(QuadXEnvState):
    wp: WaypointState
    target_deltas: Array  # (num_targets, 3|4) pre-advance remaining-target view


@dataclasses.dataclass(frozen=True)
class QuadXWaypointsEnv(QuadXBaseEnv):
    sparse_reward: bool = False
    num_targets: int = 4
    use_yaw_targets: bool = False
    goal_reach_distance: float = 0.2
    goal_reach_angle: float = 0.1
    flight_dome_size: float = 5.0
    agent_hz: int = 30

    @property
    def waypoints(self) -> WaypointHandler:
        return WaypointHandler(
            num_targets=self.num_targets,
            use_yaw_targets=self.use_yaw_targets,
            goal_reach_distance=self.goal_reach_distance,
            goal_reach_angle=self.goal_reach_angle,
            flight_dome_size=self.flight_dome_size,
        )

    def scene_boxes(self, state: QuadXWaypointsState):
        """Waypoint markers with the reference's fading colors
        (waypoint_handler.py:85-103) for gym_wrapper.render."""
        return self.waypoints.marker_boxes(state.wp)

    # ----- observation ----------------------------------------------------
    @property
    def obs_size(self) -> int:  # attitude part only; deltas are separate
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
                    shape=(self.num_targets, self.waypoints.delta_size),
                    dtype=np.float64,
                ),
            }
        )

    def _obs(self, state: QuadXWaypointsState) -> dict:
        return {
            "attitude": self.attitude_obs(state),
            "target_deltas": state.target_deltas,
        }

    # ----- reset ----------------------------------------------------------
    def reset(self, key: Array) -> tuple[QuadXWaypointsState, dict]:
        base = self.init_env_state(key)
        wp_key = jax.random.fold_in(base.key, 7)
        ws = self.waypoints.reset(wp_key, dtype=self.cfg.dtype)
        view = base.drone.read.view
        ws, deltas = self.waypoints.update_distances(
            ws, view[..., 1, :], view[..., 3, :], pm.euler_to_quat(view[..., 1, :])
        )
        state = QuadXWaypointsState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            wp=ws,
            target_deltas=self.waypoints.remaining_deltas(ws, deltas),
        )
        return state, self._obs(state)

    # ----- per-inner-step task update -------------------------------------
    def _task_update(
        self, state: QuadXWaypointsState, contact: Array
    ) -> QuadXWaypointsState:
        wph = self.waypoints
        view = state.drone.read.view
        ang_pos, lin_pos = view[..., 1, :], view[..., 3, :]

        # compute_state equivalent (quadx_waypoints_env.py:128-160)
        ws, deltas = wph.update_distances(
            state.wp, ang_pos, lin_pos, pm.euler_to_quat(ang_pos)
        )
        obs_deltas = wph.remaining_deltas(ws, deltas)
        state = state.replace(wp=ws, target_deltas=obs_deltas)

        # compute_term_trunc_reward (quadx_waypoints_env.py:162-179)
        state = self.base_term_trunc_reward(state, contact)
        reward = state.reward
        if not self.sparse_reward:
            reward = reward + jnp.maximum(3.0 * wph.progress_to_target(ws), 0.0)
            reward = reward + 0.1 / wph.immediate_distance(ws, deltas)

        reached = wph.target_reached(ws)
        reward = jnp.where(reached, 100.0, reward)
        ws_adv = wph.advance_targets(ws)
        ws = jax.tree.map(
            lambda a, b: jnp.where(reached, a, b), ws_adv, ws
        )
        all_reached = wph.all_targets_reached(ws)
        return state.replace(
            wp=ws,
            reward=reward,
            truncation=state.truncation | all_reached,
            env_complete=state.env_complete | all_reached,
        )

    def step(
        self, state: QuadXWaypointsState, action: Array
    ) -> tuple[QuadXWaypointsState, StepOut]:
        return self.base_step(
            state,
            action,
            self._task_update,
            self._obs,
            extra_info=lambda s: {"num_targets_reached": s.wp.idx},
        )
