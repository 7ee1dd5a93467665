"""Fast trajectory-following env (fork headline task).

Functional re-implementation of /root/reference/PyFlyt/gym_envs/
quadx_mod_envs/trajectory_following_fast/
{quadx_base_env.py,quadx_trajectory_following_env.py}: chase a chain of
random waypoints as fast as possible (reach distance 1 m, no hover dwell).

Preserved semantics:
- one aviary step per env step at ``control_hz`` (default 80, NED_FRD, mode 9)
- observation (19): [lin_pos, lin_vel, ang_pos (wrapped), ang_vel,
  lin_pos_error, delta_pos (next − current target), angle_diff between the
  velocity and the inter-waypoint leg], rounded to 3 decimals
  (quadx_trajectory_following_env.py:225-320); angle_diff only refreshes
  when ‖v‖ ≥ 0.01 and is 0 for a zero leg
- waypoint chain: ``ceil(max_duration_seconds)`` targets (min 2), each a
  U(−10,10)³ offset from the previous with components pushed out of (−1, 1)
  and per-axis reflection at the dome boundary / z floor
  (:148-185 — the z condition is written for NED and reproduced literally)
- reach at < ``goal_reach_distance``: advance target/next pointers (clamped
  to the last waypoint), reset the error baseline (:245-280)
- reward (:304-326): ``β·(1000 − steps-since-last-reach)`` on reach, plus
  ``α·100·progress/initial-leg-distance − γ·‖ω‖``; −1000 overwrite on
  collision; no env-complete truncation (commented out in the reference)
- the 20 m out-of-bounds check is the same dead code as the hovering env
  (bool > 20) and is reproduced by omission
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.core.wind import GaussianWind
from pyflyt_tpu.envs.base import StepOut, tree_select
from pyflyt_tpu.models import quadx


@struct.dataclass
class TrajFastState:
    drone: quadx.QuadXState
    wind: GaussianWind
    key: Array
    step_count: Array
    termination: Array
    truncation: Array
    reward: Array
    action: Array
    waypoints: Array  # (n_targets, 3)
    num_targets_reached: Array  # int32
    prev_step_count_reached: Array  # int32
    target_pos: Array  # (3,)
    next_pos: Array  # (3,)
    delta_pos: Array  # (3,)
    lin_pos_error: Array  # (3,)
    prev_lin_pos_error: Array  # (3,)
    lin_pos_error_fixed: Array  # scalar: leg length baseline
    angle_diff: Array  # scalar
    state19: Array  # (19,)
    collision: Array
    env_complete: Array


@dataclasses.dataclass(frozen=True)
class QuadXTrajectoryFollowingFastEnv:
    control_hz: int = 80
    orn_conv: str = "NED_FRD"
    randomize_start: bool = True
    start_pos: tuple = ((0.0, 0.0, -1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    random_trajectory: bool = True
    waypoints: tuple | None = None
    goal_reach_distance: float = 1.0
    min_pwm: float = 0.0
    max_pwm: float = 1.0
    noisy_motors: bool = False
    drone_model: str = "cf2x"
    flight_mode: int = 9
    simulate_wind: bool = False
    base_wind_velocities: tuple | None = None
    max_gust_strength: float = 7.0
    flight_dome_size: float = 100.0
    max_duration_seconds: float = 30.0
    normalize_obs: bool = True
    normalize_actions: bool = True
    alpha: float = 10.0
    beta: float = 1.0
    gamma: float = 0.2

    def __post_init__(self):
        assert 240 % self.control_hz == 0
        assert self.flight_mode in (-1, 7, 8, 9, 10)
        _ = self.params

    @property
    def num_of_targets(self) -> int:
        if not self.random_trajectory and self.waypoints is not None:
            return len(self.waypoints)
        return max(2, int(math.ceil(self.max_duration_seconds)))

    @property
    def max_steps(self) -> int:
        return int(self.control_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(
            drone_model=self.drone_model,
            control_hz=self.control_hz,
            orn_conv=self.orn_conv,
            noisy_motors=self.noisy_motors,
            min_pwm=self.min_pwm,
            max_pwm=self.max_pwm,
        )

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg)

    # ----- spaces -----------------------------------------------------------
    @functools.cached_property
    def obs_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.flight_dome_size + 30
        if self.orn_conv == "ENU_FLU":
            z_lo, z_hi = 0.0, d
        else:
            z_lo, z_hi = -d, 0.0
        low = np.array(
            [-d, -d, z_lo, -50, -50, -50, -np.pi, -np.pi, -np.pi,
             -130, -130, -130, -20, -20, -20, -10, -10, -10, 0]
        )
        high = np.array(
            [d, d, z_hi, 50, 50, 50, np.pi, np.pi, np.pi,
             130, 130, 130, 20, 20, 20, 10, 10, 10, np.pi]
        )
        return low, high

    @functools.cached_property
    def raw_action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        if self.flight_mode in (-1, 8):
            return np.zeros(4), np.ones(4)
        if self.flight_mode == 9:
            return np.array([-1.0, -1.0, -1.0, 0.0]), np.ones(4)
        return np.full(4, -np.inf), np.full(4, np.inf)

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        if self.normalize_actions and self.flight_mode not in (7, 10):
            return -np.ones(4), np.ones(4)
        return self.raw_action_bounds

    @property
    def obs_size(self) -> int:
        return 19

    def observation_space_factory(self, spaces):
        low, high = self.obs_bounds
        if self.normalize_obs:
            return spaces.Box(low=-np.ones(19), high=np.ones(19), dtype=np.float64)
        return spaces.Box(low=low, high=high, dtype=np.float64)

    # ----- helpers ----------------------------------------------------------
    def _round3(self, x: Array) -> Array:
        return jnp.round(x * 1000.0) / 1000.0

    def _normalize_obs(self, state19: Array) -> Array:
        if not self.normalize_obs:
            return state19
        low, high = self.obs_bounds
        low = jnp.asarray(low, state19.dtype)
        high = jnp.asarray(high, state19.dtype)
        clipped = jnp.clip(state19, low, high)
        return ((clipped - low) / (high - low)) * 2.0 - 1.0

    def _denormalize_action(self, action: Array) -> Array:
        if not self.normalize_actions or self.flight_mode in (7, 10):
            return action
        low, high = self.raw_action_bounds
        return ((action + 1.0) / 2.0) * (
            jnp.asarray(high, action.dtype) - jnp.asarray(low, action.dtype)
        ) + jnp.asarray(low, action.dtype)

    def _make_wind(self, key: Array) -> GaussianWind:
        if self.simulate_wind:
            base = (
                None
                if self.base_wind_velocities is None
                else jnp.asarray(self.base_wind_velocities, self.cfg.dtype)
            )
            return GaussianWind.init(
                key, base_wind=base, max_gust=self.max_gust_strength,
                orn_conv=self.orn_conv,
            )
        return GaussianWind.init(
            key, base_wind=jnp.zeros(3, self.cfg.dtype), max_gust=0.0,
            orn_conv=self.orn_conv,
        )

    def _sample_waypoints(self, key: Array, start: Array) -> Array:
        """The chained sampler (quadx_trajectory_following_env.py:148-185)."""
        dome = self.flight_dome_size
        dtype = self.cfg.dtype

        def body(base, k):
            s = jax.random.uniform(k, (3,), dtype, -10.0, 10.0)
            # push each component out of (-1, 1)
            s = jnp.where((s < 0.0) & (s > -1.0), -1.0, s)
            s = jnp.where((s > 0.0) & (s < 1.0), 1.0, s)
            s = jnp.where(s == 0.0, 1.0, s)
            new = base + s
            new = new.at[0].set(
                jnp.where(jnp.abs(new[0]) > dome, base[0] - s[0], new[0])
            )
            new = new.at[1].set(
                jnp.where(jnp.abs(new[1]) > dome, base[1] - s[1], new[1])
            )
            # the reference's z condition is written for NED (z negative up)
            new = new.at[2].set(
                jnp.where(
                    (jnp.abs(new[2]) > dome) | (new[2] > -1.0),
                    base[2] - s[2],
                    new[2],
                )
            )
            return new, new

        keys = jax.random.split(key, self.num_of_targets)
        _, waypoints = jax.lax.scan(body, start, keys)
        return waypoints

    # ----- state computation (compute_state, :225-320) ----------------------
    def _update_tracking(self, state: TrajFastState) -> TrajFastState:
        view = state.drone.read.view
        ang_vel = view[..., 0, :]
        ang_pos = pm.wrap_angle(view[..., 1, :])
        lin_vel = view[..., 2, :]
        lin_pos = view[..., 3, :]

        prev_err = state.lin_pos_error
        err = state.target_pos - lin_pos
        prev_reached = state.num_targets_reached

        reached = jnp.linalg.norm(err) < self.goal_reach_distance
        n = self.num_of_targets
        ntr = jnp.where(
            reached & (state.num_targets_reached < n),
            state.num_targets_reached + 1,
            state.num_targets_reached,
        )
        target_idx = jnp.minimum(ntr, n - 1)
        next_idx = jnp.minimum(ntr + 1, n - 1)
        target_pos = jnp.where(reached, state.waypoints[target_idx], state.target_pos)
        next_pos = jnp.where(reached, state.waypoints[next_idx], state.next_pos)
        delta_pos = next_pos - target_pos
        err_new = jnp.where(reached, target_pos - lin_pos, err)
        prev_err = jnp.where(reached, err_new, prev_err)
        err_fixed = jnp.where(
            reached, jnp.linalg.norm(err_new), state.lin_pos_error_fixed
        )

        speed = jnp.linalg.norm(lin_vel)
        leg = jnp.linalg.norm(delta_pos)
        cos = jnp.dot(lin_vel, delta_pos, precision="highest") / jnp.maximum(speed * leg, 1e-12)
        angle_new = jnp.where(
            leg == 0.0, 0.0, jnp.arccos(jnp.clip(cos, -1.0, 1.0))
        )
        angle_diff = jnp.where(speed >= 0.01, angle_new, state.angle_diff)

        state19 = self._round3(
            jnp.concatenate(
                [lin_pos, lin_vel, ang_pos, ang_vel, err_new, delta_pos,
                 angle_diff[None]],
                axis=-1,
            )
        )
        return state.replace(
            num_targets_reached=ntr,
            target_pos=target_pos,
            next_pos=next_pos,
            delta_pos=delta_pos,
            lin_pos_error=err_new,
            prev_lin_pos_error=prev_err,
            lin_pos_error_fixed=err_fixed,
            angle_diff=angle_diff,
            state19=state19,
        ), prev_reached

    # ----- API --------------------------------------------------------------
    def reset(self, key: Array) -> tuple[TrajFastState, Array]:
        dtype = self.cfg.dtype
        key, k_pos, k_orn, k_wp, k_wind = jax.random.split(key, 5)
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
            waypoints = self._sample_waypoints(k_wp, start_pos)
        else:
            waypoints = jnp.asarray(self.waypoints, dtype)

        drone = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        drone = quadx.set_mode(drone, self.flight_mode, self.cfg)
        wind = self._make_wind(k_wind)

        target_pos = waypoints[0]
        next_pos = waypoints[1]
        err = target_pos - start_pos
        false = jnp.zeros((), bool)
        state = TrajFastState(
            drone=drone,
            wind=wind,
            key=key,
            step_count=jnp.zeros((), jnp.int32),
            termination=false,
            truncation=false,
            reward=jnp.zeros((), dtype),
            action=jnp.zeros((4,), dtype),
            waypoints=waypoints,
            num_targets_reached=jnp.zeros((), jnp.int32),
            prev_step_count_reached=jnp.zeros((), jnp.int32),
            target_pos=target_pos,
            next_pos=next_pos,
            delta_pos=next_pos - target_pos,
            lin_pos_error=err,
            prev_lin_pos_error=err,
            lin_pos_error_fixed=jnp.linalg.norm(err),
            angle_diff=jnp.zeros((), dtype),
            state19=jnp.zeros((19,), dtype),
            collision=false,
            env_complete=false,
        )
        state, _ = self._update_tracking(state)
        return state, self._normalize_obs(state.state19)

    def step(self, state: TrajFastState, action: Array) -> tuple[TrajFastState, StepOut]:
        dtype = self.cfg.dtype
        action = self._denormalize_action(jnp.asarray(action, dtype))
        done_before = state.termination | state.truncation

        key, sub = jax.random.split(state.key)
        drone = state.drone.replace(setpoint=action)
        drone, contact = quadx.step(
            drone, self.params, self.cfg, self.flight_mode, sub,
            wind_fn=state.wind,
        )
        st = state.replace(drone=drone, key=key, action=action)
        st, prev_reached = self._update_tracking(st)

        # pre-increment check (reference quadx_base_env.py:344-346)
        truncation = st.step_count >= self.max_steps
        collision = contact

        # reward (quadx_trajectory_following_env.py:304-326)
        err_prev = jnp.linalg.norm(st.prev_lin_pos_error)
        err_now = jnp.linalg.norm(st.lin_pos_error)
        err_ang_vel = jnp.linalg.norm(st.state19[9:12])
        advanced = st.num_targets_reached > prev_reached
        reach_bonus = self.beta * (
            1000.0 - (st.step_count - st.prev_step_count_reached).astype(dtype)
        )
        reward = jnp.where(advanced, reach_bonus, 0.0)
        prev_step_reached = jnp.where(
            advanced, st.step_count, st.prev_step_count_reached
        )
        reward = reward + (
            self.alpha
            * (100.0 * (err_prev - err_now) / jnp.maximum(st.lin_pos_error_fixed, 1e-12))
        ) - (self.gamma * err_ang_vel)
        reward = jnp.where(collision, -1000.0, reward).astype(dtype)

        new_state = st.replace(
            step_count=st.step_count + 1,
            termination=st.termination | collision,
            truncation=st.truncation | truncation,
            reward=reward,
            prev_step_count_reached=prev_step_reached,
            collision=st.collision | collision,
        )
        new_state = tree_select(done_before, state, new_state)
        out = StepOut(
            obs=self._normalize_obs(new_state.state19),
            reward=jnp.where(done_before, 0.0, new_state.reward).astype(dtype),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": jnp.zeros((), bool),  # dead code in reference
                "env_complete": new_state.env_complete,
                "num_targets_reached": new_state.num_targets_reached,
            },
        )
        return new_state, out
