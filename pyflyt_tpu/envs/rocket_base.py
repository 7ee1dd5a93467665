"""Shared machinery for Rocket Gymnasium-style tasks.

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/rocket_envs/rocket_base_env.py. Differences
from the QuadX/Fixedwing bases that the reference has (preserved here):

- reward baseline is 0.0, not −0.1, and base termination does NOT overwrite
  the reward (rocket_base_env.py:317-319; the −100 lines are commented out in
  the reference)
- termination on: collision (minus ignored pairs), below ground
  (z < 0), xy displacement > max_displacement, or z > ceiling
  (rocket_base_env.py:288-306)
- ``randomize_drop`` spawn randomization + ``accelerate_drop`` −100 m/s drop
  (rocket_base_env.py:179-221; note the reference's "randoimize_drop" typo
  means random spawn *velocities* never trigger — reproduced by not
  implementing them)
- action (7): [finlet x, finlet y, finlet yaw ∈ ±1, ignition ∈ [0,1],
  throttle ∈ [0,1], gimbal x, gimbal y ∈ ±1]
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut, tree_select
from pyflyt_tpu.models import rocket

CONTROL_HZ = 120


@struct.dataclass
class RocketEnvState:
    drone: rocket.RocketState
    key: Array
    step_count: Array
    termination: Array
    truncation: Array
    reward: Array
    action: Array  # (7,)
    fatal_collision: Array
    out_of_bounds: Array
    env_complete: Array


@dataclasses.dataclass(frozen=True)
class RocketBaseEnv:
    start_pos: tuple = ((0.0, 0.0, 450.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    ceiling: float = 500.0
    max_displacement: float = 200.0
    max_duration_seconds: float = 30.0
    angle_representation: str = "quaternion"
    agent_hz: int = 40
    drone_model: str = "rocket"
    starting_fuel_ratio: float = 0.01  # landing env drone_options
    randomize_drop: bool = True
    accelerate_drop: bool = True
    noisy_boosters: bool = True  # booster-noise toggle (parity testing)

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise AssertionError(
                f"`agent_hz` must be a round denominator of {CONTROL_HZ}."
            )
        assert self.angle_representation in ("euler", "quaternion")
        _ = self.params

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> rocket.RocketConfig:
        return rocket.RocketConfig(
            drone_model=self.drone_model,
            control_hz=CONTROL_HZ,
            starting_fuel_ratio=self.starting_fuel_ratio,
            noisy_boosters=self.noisy_boosters,
        )

    @functools.cached_property
    def params(self) -> rocket.RocketParams:
        return rocket.build_params(self.cfg)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def combined_size(self) -> int:
        # attitude + previous action (7) + auxiliary (9)
        return self.attitude_size + 7 + 9

    @property
    def action_size(self) -> int:
        return 7

    # third-person render box (rocket.urdf: cylinder r=0.185, l=4.77)
    render_half_extents = (0.2, 0.2, 2.4)

    def action_bounds(self):
        import numpy as np

        high = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
        low = np.array([-1.0, -1.0, -1.0, 0.0, 0.0, -1.0, -1.0])
        return low, high

    # ----- shared pieces ---------------------------------------------------
    def attitude_obs(self, state: RocketEnvState) -> Array:
        view = state.drone.read.view
        parts = [view[..., 0, :]]
        if self.angle_representation == "quaternion":
            parts.append(pm.euler_to_quat(view[..., 1, :]))
        else:
            parts.append(view[..., 1, :])
        parts += [
            view[..., 2, :],
            view[..., 3, :],
            state.action,
            rocket.aux_state(state.drone),
        ]
        return jnp.concatenate(parts, axis=-1)

    def base_term_trunc(
        self, state: RocketEnvState, fatal_contact: Array
    ) -> RocketEnvState:
        """rocket_base_env.py:277-306 — no reward overwrite."""
        truncation = state.truncation | (state.step_count > self.max_steps)
        lin_pos = state.drone.read.view[..., 3, :]
        below_ground = lin_pos[..., 2] < 0.0
        fatal = fatal_contact | below_ground
        oob = (
            jnp.linalg.norm(lin_pos[..., :2], axis=-1) > self.max_displacement
        ) | (lin_pos[..., 2] > self.ceiling)
        return state.replace(
            truncation=truncation,
            termination=state.termination | fatal | oob,
            fatal_collision=state.fatal_collision | fatal,
            out_of_bounds=state.out_of_bounds | oob,
        )

    def sample_spawn(self, key: Array) -> tuple[Array, Array, Array]:
        """(start_pos, start_orn, start_lin_vel) with drop randomization
        (rocket_base_env.py:179-218)."""
        dtype = self.cfg.dtype
        pos = jnp.asarray(self.start_pos[0], dtype=dtype)
        orn = jnp.asarray(self.start_orn[0], dtype=dtype)
        k_xy, k_z, k_orn = jax.random.split(key, 3)
        if self.randomize_drop:
            spawn_range = self.max_displacement * 0.1
            xy = jax.random.uniform(
                k_xy, (2,), dtype, -spawn_range, spawn_range
            )
            z = jax.random.uniform(
                k_z, (), dtype, self.ceiling * 0.8, self.ceiling * 0.9
            )
            pos = jnp.concatenate([xy, z[None]])
            orn = jax.random.uniform(k_orn, (3,), dtype, -0.3, 0.3)
        lin_vel = jnp.zeros(3, dtype=dtype)
        if self.accelerate_drop:
            lin_vel = lin_vel.at[2].add(-100.0)
        return pos, orn, lin_vel

    def init_env_state(
        self, key: Array, pad_position: Array | None = None
    ) -> RocketEnvState:
        key, spawn_key = jax.random.split(key)
        pos, orn, lin_vel = self.sample_spawn(spawn_key)
        drone = rocket.init_state(self.params, self.cfg, pos, orn, lin_vel)

        def stab(carry, _):
            drone, key = carry
            key, sub = jax.random.split(key)
            drone, _, _ = rocket.step(
                drone, self.params, self.cfg, sub, pad_position=pad_position
            )
            return (drone, key), None

        (drone, key), _ = jax.lax.scan(stab, (drone, key), None, length=10)
        false = jnp.zeros((), dtype=bool)
        dtype = self.cfg.dtype
        return RocketEnvState(
            drone=drone,
            key=key,
            step_count=jnp.zeros((), dtype=jnp.int32),
            termination=false,
            truncation=false,
            reward=jnp.zeros((), dtype=dtype),
            action=jnp.zeros((7,), dtype=dtype),
            fatal_collision=false,
            out_of_bounds=false,
            env_complete=false,
        )

    def base_step(
        self,
        state: RocketEnvState,
        action: Array,
        task_update: Callable[[RocketEnvState, Array, Array], RocketEnvState],
        obs_fn: Callable[[RocketEnvState], Any],
        pad_position: Array | None = None,
        extra_info: Callable[[RocketEnvState], dict[str, Any]] | None = None,
    ) -> tuple[RocketEnvState, StepOut]:
        """Agent-step loop; ``task_update(state, contact, pad_contact)``
        runs after each inner aviary step (rocket_base_env.py:308-345)."""
        action = jnp.asarray(action, dtype=self.cfg.dtype)
        state = state.replace(
            action=action,
            reward=jnp.zeros((), dtype=self.cfg.dtype),
            drone=state.drone.replace(setpoint=action),
        )

        def inner(st: RocketEnvState, _):
            done_before = st.termination | st.truncation
            key, sub = jax.random.split(st.key)
            drone, contact, pad_contact = rocket.step(
                st.drone, self.params, self.cfg, sub, pad_position=pad_position
            )
            new_st = task_update(
                st.replace(drone=drone, key=key), contact, pad_contact
            )
            return tree_select(done_before, st, new_st), None

        state, _ = jax.lax.scan(inner, state, None, length=self.env_step_ratio)
        state = state.replace(step_count=state.step_count + 1)
        out = StepOut(
            obs=obs_fn(state),
            reward=state.reward,
            termination=state.termination,
            truncation=state.truncation,
            info={
                "fatal_collision": state.fatal_collision,
                "out_of_bounds": state.out_of_bounds,
                "env_complete": state.env_complete,
                **(extra_info(state) if extra_info is not None else {}),
            },
        )
        return state, out
