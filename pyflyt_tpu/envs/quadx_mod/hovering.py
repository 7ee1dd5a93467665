"""Modified QuadX Hovering env (the fork's RL training workhorse).

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/quadx_mod_envs/hovering/
{quadx_base_env.py,quadx_hovering_env.py}. Departures from the stock hover
env that the fork introduced (all preserved):

- the agent acts at the drone's ``control_hz`` — exactly ONE aviary step per
  env step (quadx_base_env.py:371-372), no inner loop
- bounded observation space with physical limits, optionally normalized to
  [−1, 1]; actions optionally normalized likewise (:80-170, 359-386)
- observation (16): [lin_pos, lin_vel, ang_pos (wrapped), ang_vel,
  lin_pos_error, psi_error], rounded to 3 decimals
  (quadx_hovering_env.py:148-176)
- reward ``35 − α·‖pos_err‖ − β·‖vel‖ − γ·|psi_err| − δ·‖ω‖`` with defaults
  α=2, β=0.1, γ=4, δ=0.1; −1000 overwrite on collision
  (quadx_hovering_env.py:178-195, quadx_base_env.py:327-344)
- randomized target position/yaw in the dome; spawn = target + U(−10, 10)
  with ±10° roll/pitch and random yaw (quadx_hovering_env.py:112-141)
- optional GaussianWindField (quadx_base_env.py:247-255)
- flight modes restricted to {−1, 7, 8, 9, 10} with mode-specific action
  bounds (quadx_base_env.py:143-169)

Reference quirk preserved: the 20 m position-error termination at
quadx_base_env.py:341-344 is dead code (``np.any(...) > 20`` compares a bool
to 20) — so only collision and the step limit end episodes; we reproduce
that by not implementing the check.
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
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.models import quadx


@struct.dataclass
class ModHoverState:
    drone: quadx.QuadXState
    wind: GaussianWind  # inactive (zero base/gust) when simulate_wind=False
    key: Array
    step_count: Array
    termination: Array
    truncation: Array
    reward: Array
    action: Array  # (4,) raw (denormalized) action
    target_pos: Array  # (3,)
    target_psi: Array  # scalar
    state16: Array  # (16,) the unnormalized observation vector
    collision: Array
    env_complete: Array


@dataclasses.dataclass(frozen=True)
class QuadXModHoveringEnv:
    control_hz: int = 40
    orn_conv: str = "ENU_FLU"
    start_pos: tuple = ((0.0, 0.0, 1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    noisy_motors: bool = True
    min_pwm: float = 0.0
    max_pwm: float = 1.0
    drone_model: str = "cf2x"
    simulate_wind: bool = False
    base_wind_velocities: tuple | None = None
    max_gust_strength: float = 7.0
    flight_mode: int = 0  # reference default (quadx_base_env.py:37)
    flight_dome_size: float = 100.0
    max_duration_seconds: float = 10.0
    normalize_obs: bool = True
    normalize_actions: bool = True
    randomize_start: bool = True
    target_pos: tuple = (0.0, 0.0, 1.0)
    target_psi: float = 0.0
    alpha: float = 2.0
    beta: float = 0.1
    gamma: float = 4.0
    delta: float = 0.1

    def __post_init__(self):
        assert 240 % self.control_hz == 0, (
            "`control_hz` must be a round denominator of 240."
        )
        assert self.flight_mode in (-1, 7, 8, 9, 10), (
            f"Invalid flight mode {self.flight_mode}, only -1, 7, 8, 9, 10 allowed."
        )
        _ = self.params

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

    # ----- spaces (quadx_base_env.py:80-170) -------------------------------
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

    @functools.cached_property
    def raw_action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        if self.flight_mode in (-1, 8):
            return np.zeros(4), np.ones(4)
        if self.flight_mode == 9:
            return np.array([-1.0, -1.0, -1.0, 0.0]), np.ones(4)
        # modes 7 / 10: unbounded
        return np.full(4, -np.inf), np.full(4, np.inf)

    def action_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """The agent-facing bounds ([−1, 1] when normalized)."""
        low, high = self.raw_action_bounds
        if self.normalize_actions and self.flight_mode not in (7, 10):
            return -np.ones(4), np.ones(4)
        return low, high

    @property
    def obs_size(self) -> int:
        return 16

    def observation_space_factory(self, spaces):
        low, high = self.obs_bounds
        if self.normalize_obs:
            return spaces.Box(low=-np.ones(16), high=np.ones(16), dtype=np.float64)
        return spaces.Box(low=low, high=high, dtype=np.float64)

    # ----- internals --------------------------------------------------------
    def _round3(self, x: Array) -> Array:
        """The reference rounds states to 3 decimals (np.round(..., 3))."""
        return jnp.round(x * 1000.0) / 1000.0

    def _compute_state16(
        self, drone: quadx.QuadXState, target_pos: Array, target_psi: Array
    ) -> Array:
        """quadx_hovering_env.py:148-176."""
        view = drone.read.view
        ang_vel = view[..., 0, :]
        ang_pos = pm.wrap_angle(view[..., 1, :])
        lin_vel = view[..., 2, :]
        lin_pos = view[..., 3, :]
        psi_err = pm.wrap_angle(target_psi - ang_pos[..., 2])
        pos_err = target_pos - lin_pos
        return self._round3(
            jnp.concatenate(
                [
                    lin_pos,
                    lin_vel,
                    ang_pos,
                    ang_vel,
                    pos_err,
                    psi_err[..., None],
                ],
                axis=-1,
            )
        )

    def _normalize_obs(self, state16: Array) -> Array:
        if not self.normalize_obs:
            return state16
        low, high = self.obs_bounds
        low = jnp.asarray(low, state16.dtype)
        high = jnp.asarray(high, state16.dtype)
        clipped = jnp.clip(state16, low, high)
        return ((clipped - low) / (high - low)) * 2.0 - 1.0

    def _denormalize_action(self, action: Array) -> Array:
        if not self.normalize_actions or self.flight_mode in (7, 10):
            return action
        low, high = self.raw_action_bounds
        low = jnp.asarray(low, action.dtype)
        high = jnp.asarray(high, action.dtype)
        return ((action + 1.0) / 2.0) * (high - low) + low

    def _make_wind(self, key: Array) -> GaussianWind:
        if self.simulate_wind:
            base = (
                None
                if self.base_wind_velocities is None
                else jnp.asarray(self.base_wind_velocities, self.cfg.dtype)
            )
            return GaussianWind.init(
                key,
                base_wind=base,
                max_gust=self.max_gust_strength,
                orn_conv=self.orn_conv,
            )
        # inactive wind: zero base, zero gusts
        return GaussianWind.init(
            key, base_wind=jnp.zeros(3, self.cfg.dtype), max_gust=0.0,
            orn_conv=self.orn_conv,
        )

    # ----- API --------------------------------------------------------------
    def reset(self, key: Array) -> tuple[ModHoverState, Array]:
        dtype = self.cfg.dtype
        key, k_t, k_psi, k_s, k_orn, k_wind = jax.random.split(key, 6)

        if self.randomize_start:
            dome = self.flight_dome_size
            xy = jax.random.uniform(k_t, (2,), dtype, -dome, dome)
            if self.orn_conv == "ENU_FLU":
                z = jax.random.uniform(jax.random.fold_in(k_t, 1), (), dtype, 1.0, dome)
            else:
                z = jax.random.uniform(
                    jax.random.fold_in(k_t, 1), (), dtype, -dome, -1.0
                )
            target_pos = self._round3(jnp.concatenate([xy, z[None]]))
            target_psi = self._round3(
                jax.random.uniform(k_psi, (), dtype, -jnp.pi, jnp.pi)
            )
            start_pos = self._round3(
                target_pos + jax.random.uniform(k_s, (3,), dtype, -10.0, 10.0)
            )
            rp = jax.random.uniform(k_orn, (2,), dtype, -0.174533, 0.174533)
            psi0 = jax.random.uniform(
                jax.random.fold_in(k_orn, 1), (), dtype, -jnp.pi, jnp.pi
            )
            start_orn = self._round3(jnp.concatenate([rp, psi0[None]]))
        else:
            target_pos = jnp.asarray(self.target_pos, dtype)
            target_psi = jnp.asarray(self.target_psi, dtype)
            start_pos = jnp.asarray(self.start_pos[0], dtype)
            start_orn = jnp.asarray(self.start_orn[0], dtype)

        wind = self._make_wind(k_wind)
        drone = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        drone = quadx.set_mode(drone, self.flight_mode, self.cfg)
        # no stabilization steps in the mod env (quadx_base_env.py:284-287
        # commented out); state computed immediately
        state16 = self._compute_state16(drone, target_pos, target_psi)
        false = jnp.zeros((), bool)
        state = ModHoverState(
            drone=drone,
            wind=wind,
            key=key,
            step_count=jnp.zeros((), jnp.int32),
            termination=false,
            truncation=false,
            reward=jnp.zeros((), dtype),
            action=jnp.zeros((4,), dtype),
            target_pos=target_pos,
            target_psi=target_psi,
            state16=state16,
            collision=false,
            env_complete=false,
        )
        return state, self._normalize_obs(state16)

    def step(self, state: ModHoverState, action: Array) -> tuple[ModHoverState, StepOut]:
        """One env step = one aviary step (quadx_base_env.py:346-424)."""
        dtype = self.cfg.dtype
        action = self._denormalize_action(jnp.asarray(action, dtype))
        done_before = state.termination | state.truncation

        key, sub = jax.random.split(state.key)
        drone = state.drone.replace(setpoint=action)
        drone, contact = quadx.step(
            drone, self.params, self.cfg, self.flight_mode, sub,
            wind_fn=state.wind,
        )
        state16 = self._compute_state16(drone, state.target_pos, state.target_psi)

        # term/trunc/reward (quadx_base_env.py:327-344 + hovering:178-195)
        # reference checks BEFORE the end-of-step increment
        # (quadx_base_env.py:329-332): truncation fires on call max_steps+1
        truncation = state.step_count >= self.max_steps
        collision = contact
        err_dist = jnp.linalg.norm(state16[..., 12:15], axis=-1)
        err_vel = jnp.linalg.norm(state16[..., 3:6], axis=-1)
        err_psi = jnp.abs(state16[..., 15])
        err_ang_vel = jnp.linalg.norm(state16[..., 9:12], axis=-1)
        reward = 35.0 + (
            -self.alpha * err_dist
            - self.beta * err_vel
            - self.gamma * err_psi
            - self.delta * err_ang_vel
        )
        reward = jnp.where(collision, -1000.0, reward).astype(dtype)
        termination = collision

        new_state = ModHoverState(
            drone=drone,
            wind=state.wind,
            key=key,
            step_count=state.step_count + 1,
            termination=state.termination | termination,
            truncation=state.truncation | truncation,
            reward=reward,
            action=action,
            target_pos=state.target_pos,
            target_psi=state.target_psi,
            state16=state16,
            collision=state.collision | collision,
            env_complete=state.env_complete,
        )
        # freeze after done (the gym wrapper resets; vectorized use auto-resets)
        from pyflyt_tpu.envs.base import tree_select

        new_state = tree_select(done_before, state, new_state)
        out = StepOut(
            obs=self._normalize_obs(new_state.state16),
            reward=jnp.where(done_before, 0.0, new_state.reward).astype(dtype),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": jnp.zeros((), bool),  # dead code in reference
                "env_complete": new_state.env_complete,
            },
        )
        return new_state, out
