"""Shared machinery for Fixedwing Gymnasium-style tasks.

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/fixedwing_envs/fixedwing_base_env.py with the
same stepping semantics as the QuadX base (see quadx_base.py): 120 Hz control,
``env_step_ratio`` inner aviary steps per agent step, reward −0.1 baseline
overwritten to −100 by base termination, early-exit freeze, 10 stabilization
steps on reset. Action = [roll cmd, pitch-pair cmd, (unused), thrust] in
[−1, 1]³ × [0, 1] (fixedwing_base_env.py:76-99).
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
from pyflyt_tpu.models import fixedwing

CONTROL_HZ = 120


@struct.dataclass
class FixedwingEnvState:
    drone: fixedwing.FixedwingState
    key: Array
    step_count: Array
    termination: Array
    truncation: Array
    reward: Array
    action: Array  # (4,)
    collision: Array
    out_of_bounds: Array
    env_complete: Array


@dataclasses.dataclass(frozen=True)
class FixedwingBaseEnv:
    start_pos: tuple = ((0.0, 0.0, 1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    flight_mode: int = 0
    flight_dome_size: float = float("inf")
    max_duration_seconds: float = 10.0
    angle_representation: str = "quaternion"
    agent_hz: int = 30
    drone_model: str = "fixedwing"
    noisy_motors: bool = True

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
    def cfg(self) -> fixedwing.FixedwingConfig:
        return fixedwing.FixedwingConfig(
            drone_model=self.drone_model,
            control_hz=CONTROL_HZ,
            noisy_motors=self.noisy_motors,
        )

    @functools.cached_property
    def params(self) -> fixedwing.FixedwingParams:
        return fixedwing.build_params(self.cfg)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def combined_size(self) -> int:
        # attitude + previous action (4) + auxiliary (5 surfaces + 1 motor)
        return self.attitude_size + 4 + 6

    @property
    def action_size(self) -> int:
        return 4

    # third-person render box (span 2.5 m, length 1.4 m)
    render_half_extents = (0.7, 1.25, 0.1)

    def action_bounds(self):
        """±1 control surfaces, [0, 1] thrust (fixedwing_base_env.py:76-99)."""
        import numpy as np

        return np.array([-1.0, -1.0, -1.0, 0.0]), np.array([1.0, 1.0, 1.0, 1.0])

    # ----- shared pieces ---------------------------------------------------
    def attitude_obs(self, state: FixedwingEnvState) -> Array:
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
            fixedwing.aux_state(state.drone),
        ]
        return jnp.concatenate(parts, axis=-1)

    def base_term_trunc_reward(
        self, state: FixedwingEnvState, contact: Array
    ) -> FixedwingEnvState:
        """(fixedwing_base_env.py:236-252)"""
        truncation = state.truncation | (state.step_count > self.max_steps)
        lin_pos = state.drone.read.view[..., 3, :]
        oob = jnp.linalg.norm(lin_pos, axis=-1) > self.flight_dome_size
        fatal = contact | oob
        reward = jnp.where(fatal, -100.0, state.reward)
        return state.replace(
            truncation=truncation,
            termination=state.termination | fatal,
            reward=reward,
            collision=state.collision | contact,
            out_of_bounds=state.out_of_bounds | oob,
        )

    def init_env_state(self, key: Array) -> FixedwingEnvState:
        dtype = self.cfg.dtype
        pos = jnp.asarray(self.start_pos[0], dtype=dtype)
        orn = jnp.asarray(self.start_orn[0], dtype=dtype)
        drone = fixedwing.init_state(self.params, self.cfg, pos, orn, self.flight_mode)

        def stab(carry, _):
            drone, key = carry
            key, sub = jax.random.split(key)
            drone, _ = fixedwing.step(
                drone, self.params, self.cfg, self.flight_mode, sub
            )
            return (drone, key), None

        (drone, key), _ = jax.lax.scan(stab, (drone, key), None, length=10)
        false = jnp.zeros((), dtype=bool)
        return FixedwingEnvState(
            drone=drone,
            key=key,
            step_count=jnp.zeros((), dtype=jnp.int32),
            termination=false,
            truncation=false,
            reward=jnp.zeros((), dtype=dtype),
            action=jnp.zeros((4,), dtype=dtype),
            collision=false,
            out_of_bounds=false,
            env_complete=false,
        )

    def base_step(
        self,
        state: FixedwingEnvState,
        action: Array,
        task_update: Callable[[FixedwingEnvState, Array], FixedwingEnvState],
        obs_fn: Callable[[FixedwingEnvState], Any],
        extra_info: Callable[[FixedwingEnvState], dict[str, Any]] | None = None,
    ) -> tuple[FixedwingEnvState, StepOut]:
        action = jnp.asarray(action, dtype=self.cfg.dtype)
        state = state.replace(
            action=action,
            reward=jnp.asarray(-0.1, dtype=self.cfg.dtype),
            drone=state.drone.replace(setpoint=action),
        )

        def inner(st: FixedwingEnvState, _):
            done_before = st.termination | st.truncation
            key, sub = jax.random.split(st.key)
            drone, contact = fixedwing.step(
                st.drone, self.params, self.cfg, self.flight_mode, sub
            )
            new_st = task_update(st.replace(drone=drone, key=key), contact)
            return tree_select(done_before, st, new_st), None

        state, _ = jax.lax.scan(inner, state, None, length=self.env_step_ratio)
        state = state.replace(step_count=state.step_count + 1)
        out = StepOut(
            obs=obs_fn(state),
            reward=state.reward,
            termination=state.termination,
            truncation=state.truncation,
            info={
                "collision": state.collision,
                "out_of_bounds": state.out_of_bounds,
                "env_complete": state.env_complete,
                **(extra_info(state) if extra_info is not None else {}),
            },
        )
        return state, out
