"""Slow (hover-at-waypoint) trajectory-following env.

Functional re-implementation of /root/reference/PyFlyt/gym_envs/
quadx_mod_envs/trajectory_following_slow/quadx_trajectory_following_env.py:
reach each waypoint in position (< 0.3 m), yaw (< 5°) AND near-zero speed
(‖v‖ < 1) before the next one appears.

Preserved semantics:
- observation (16) identical to the hovering env layout: [lin_pos, lin_vel,
  ang_pos, ang_vel, lin_pos_error, yaw_error] (:330-341)
- random mode regenerates ONE waypoint (offset chain from the current
  target, components pushed out of (−1, 1), dome/z reflection) plus a fresh
  random yaw on every reach (:270-324); fixed mode walks a provided
  ``(n, 4)`` [x, y, z, ψ] list (:245-260)
- reward ``40·targets_reached + 35 − α·‖pos_err‖ − β·|ψ_err| − γ·‖ω‖`` with
  defaults α=2, β=4, γ=0.2 (:344-354); −1000 overwrite on collision
- same one-aviary-step-per-env-step loop and obs/action normalization as the
  other mod envs (base env is byte-identical to the fast variant's)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.core.wind import GaussianWind
from pyflyt_tpu.envs.base import StepOut, tree_select
from pyflyt_tpu.envs.quadx_mod.trajectory_following_fast import (
    QuadXTrajectoryFollowingFastEnv,
)
from pyflyt_tpu.models import quadx


@struct.dataclass
class TrajSlowState:
    drone: quadx.QuadXState
    wind: GaussianWind
    key: Array
    step_count: Array
    termination: Array
    truncation: Array
    reward: Array
    action: Array
    current_target_index: Array  # int32
    target_pos: Array  # (3,)
    target_psi: Array  # scalar
    fixed_waypoints: Array  # (n, 4) for fixed mode (zeros in random mode)
    state16: Array
    collision: Array
    env_complete: Array


@dataclasses.dataclass(frozen=True)
class QuadXTrajectoryFollowingSlowEnv(QuadXTrajectoryFollowingFastEnv):
    """Static config. Inherits spaces/sampling helpers from the fast env but
    overrides the 16-dim observation and hover-reach semantics."""

    goal_reach_distance: float = 0.3
    goal_reach_angle: float = float(np.deg2rad(5))
    alpha: float = 2.0
    beta: float = 4.0
    gamma: float = 0.2

    @functools.cached_property
    def obs_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.flight_dome_size + 25
        if self.orn_conv == "ENU_FLU":
            z_lo, z_hi = 0.0, d
        else:
            z_lo, z_hi = -d, 0.0
        low = np.array(
            [-d, -d, z_lo, -50, -50, -50, -np.pi, -np.pi, -np.pi,
             -130, -130, -130, -20, -20, -20, -np.pi]
        )
        high = np.array(
            [d, d, z_hi, 50, 50, 50, np.pi, np.pi, np.pi,
             130, 130, 130, 20, 20, 20, np.pi]
        )
        return low, high

    @property
    def obs_size(self) -> int:
        return 16

    def observation_space_factory(self, spaces):
        low, high = self.obs_bounds
        if self.normalize_obs:
            return spaces.Box(low=-np.ones(16), high=np.ones(16), dtype=np.float64)
        return spaces.Box(low=low, high=high, dtype=np.float64)

    # ----- waypoint regeneration (one at a time) ---------------------------
    def _next_waypoint(self, key: Array, base: Array) -> Array:
        dome = self.flight_dome_size
        s = jax.random.uniform(key, (3,), self.cfg.dtype, -10.0, 10.0)
        s = jnp.where((s < 0.0) & (s > -1.0), -1.0, s)
        s = jnp.where((s > 0.0) & (s < 1.0), 1.0, s)
        s = jnp.where(s == 0.0, 1.0, s)
        new = base + s
        new = new.at[0].set(jnp.where(jnp.abs(new[0]) > dome, base[0] - s[0], new[0]))
        new = new.at[1].set(jnp.where(jnp.abs(new[1]) > dome, base[1] - s[1], new[1]))
        new = new.at[2].set(
            jnp.where((jnp.abs(new[2]) > dome) | (new[2] > -1.0), base[2] - s[2], new[2])
        )
        return new

    def _compute_state16(self, drone, target_pos, target_psi):
        view = drone.read.view
        ang_pos = pm.wrap_angle(view[..., 1, :])
        err = target_pos - view[..., 3, :]
        yaw_err = pm.wrap_angle(target_psi - ang_pos[..., 2])
        return self._round3(
            jnp.concatenate(
                [view[..., 3, :], view[..., 2, :], ang_pos, view[..., 0, :],
                 err, yaw_err[..., None]],
                axis=-1,
            )
        )

    # ----- API --------------------------------------------------------------
    def reset(self, key: Array) -> tuple[TrajSlowState, Array]:
        dtype = self.cfg.dtype
        key, k_pos, k_orn, k_wp, k_psi, k_wind = jax.random.split(key, 6)
        if self.randomize_start:
            dome = self.flight_dome_size
            xy = jax.random.uniform(k_pos, (2,), dtype, -dome, dome)
            if self.orn_conv == "ENU_FLU":
                z = jax.random.uniform(jax.random.fold_in(k_pos, 1), (), dtype, 1.0, dome)
            else:
                z = jax.random.uniform(
                    jax.random.fold_in(k_pos, 1), (), dtype, -dome, -1.0
                )
            start_pos = jnp.concatenate([xy, z[None]])
            rp = jax.random.uniform(k_orn, (2,), dtype, -0.174533, 0.174533)
            psi = jax.random.uniform(
                jax.random.fold_in(k_orn, 1), (), dtype, -jnp.pi, jnp.pi
            )
            start_orn = jnp.concatenate([rp, psi[None]])
        else:
            start_pos = jnp.asarray(self.start_pos[0], dtype)
            start_orn = jnp.asarray(self.start_orn[0], dtype)

        if self.random_trajectory:
            target_pos = self._next_waypoint(k_wp, start_pos)
            target_psi = jax.random.uniform(k_psi, (), dtype, -jnp.pi, jnp.pi)
            fixed = jnp.zeros((1, 4), dtype)
        else:
            fixed = jnp.asarray(self.waypoints, dtype)  # (n, 4)
            target_pos = fixed[0, :3]
            target_psi = fixed[0, 3]

        drone = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        drone = quadx.set_mode(drone, self.flight_mode, self.cfg)
        wind = self._make_wind(k_wind)
        false = jnp.zeros((), bool)
        state = TrajSlowState(
            drone=drone,
            wind=wind,
            key=key,
            step_count=jnp.zeros((), jnp.int32),
            termination=false,
            truncation=false,
            reward=jnp.zeros((), dtype),
            action=jnp.zeros((4,), dtype),
            current_target_index=jnp.zeros((), jnp.int32),
            target_pos=target_pos,
            target_psi=target_psi,
            fixed_waypoints=fixed,
            state16=jnp.zeros((16,), dtype),
            collision=false,
            env_complete=false,
        )
        state = state.replace(
            state16=self._compute_state16(drone, target_pos, target_psi)
        )
        return state, self._normalize_obs(state.state16)

    def step(self, state: TrajSlowState, action: Array) -> tuple[TrajSlowState, StepOut]:
        dtype = self.cfg.dtype
        action = self._denormalize_action(jnp.asarray(action, dtype))
        done_before = state.termination | state.truncation

        key, sub, k_wp, k_psi = jax.random.split(state.key, 4)
        drone = state.drone.replace(setpoint=action)
        drone, contact = quadx.step(
            drone, self.params, self.cfg, self.flight_mode, sub,
            wind_fn=state.wind,
        )

        # compute_state + reach handling (:230-341)
        view = drone.read.view
        ang_pos = pm.wrap_angle(view[..., 1, :])
        lin_vel = view[..., 2, :]
        err = state.target_pos - view[..., 3, :]
        yaw_err = pm.wrap_angle(state.target_psi - ang_pos[..., 2])
        reached = (
            (jnp.linalg.norm(err) < self.goal_reach_distance)
            & (jnp.abs(yaw_err) < self.goal_reach_angle)
            & (jnp.linalg.norm(lin_vel) < 1.0)
        )
        if self.random_trajectory:
            idx = state.current_target_index + reached.astype(jnp.int32)
            new_pos = self._next_waypoint(k_wp, state.target_pos)
            new_psi = jax.random.uniform(k_psi, (), dtype, -jnp.pi, jnp.pi)
            target_pos = jnp.where(reached, new_pos, state.target_pos)
            target_psi = jnp.where(reached, new_psi, state.target_psi)
        else:
            n = self.fixed_num_targets
            idx = jnp.minimum(
                state.current_target_index + reached.astype(jnp.int32), n - 1
            )
            target_pos = jnp.where(
                reached, state.fixed_waypoints[idx, :3], state.target_pos
            )
            target_psi = jnp.where(
                reached, state.fixed_waypoints[idx, 3], state.target_psi
            )
        state16 = self._compute_state16(drone, target_pos, target_psi)

        # pre-increment check (reference quadx_base_env.py:344-346)
        truncation = state.step_count >= self.max_steps
        collision = contact

        # reward (:344-354)
        err_dist = jnp.linalg.norm(state16[12:15])
        err_psi = jnp.abs(state16[15])
        err_ang_vel = jnp.linalg.norm(state16[9:12])
        reward = 40.0 * idx.astype(dtype) + (
            35.0
            - self.alpha * err_dist
            - self.beta * err_psi
            - self.gamma * err_ang_vel
        )
        reward = jnp.where(collision, -1000.0, reward).astype(dtype)

        new_state = state.replace(
            drone=drone,
            key=key,
            step_count=state.step_count + 1,
            termination=state.termination | collision,
            truncation=state.truncation | truncation,
            reward=reward,
            action=action,
            current_target_index=idx,
            target_pos=target_pos,
            target_psi=target_psi,
            state16=state16,
            collision=state.collision | collision,
        )
        new_state = tree_select(done_before, state, new_state)
        out = StepOut(
            obs=self._normalize_obs(new_state.state16),
            reward=jnp.where(done_before, 0.0, new_state.reward).astype(dtype),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": jnp.zeros((), bool),
                "env_complete": new_state.env_complete,
                "num_targets_reached": new_state.current_target_index,
            },
        )
        return new_state, out

    @property
    def fixed_num_targets(self) -> int:
        assert self.waypoints is not None
        return len(self.waypoints)
