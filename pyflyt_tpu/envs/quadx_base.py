"""Shared machinery for QuadX Gymnasium-style tasks.

Functional re-implementation of
/root/reference/PyFlyt/gym_envs/quadx_envs/quadx_base_env.py with identical
stepping semantics:

- agent acts every ``env_step_ratio = 120 / agent_hz`` aviary steps
  (quadx_base_env.py:114)
- reward starts at −0.1 each agent step and is shaped *per inner aviary step*,
  with base termination overwriting it to −100 (quadx_base_env.py:258-274,
  230-246)
- the inner loop early-exits once terminated/truncated — reproduced by
  freezing the carry (no state updates, no RNG draws) after done
- reset performs 10 stabilization aviary steps (quadx_base_env.py:188-189)
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
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.models import quadx

CONTROL_HZ = 120  # the envs hardcode 120 Hz control (quadx_base_env.py:45-50)


@struct.dataclass
class QuadXEnvState:
    drone: quadx.QuadXState
    key: Array
    step_count: Array  # int32
    termination: Array  # bool
    truncation: Array  # bool
    reward: Array  # running reward of the current agent step
    action: Array  # (4,) current/previous action
    collision: Array  # bool info flag
    out_of_bounds: Array  # bool info flag
    env_complete: Array  # bool info flag


@dataclasses.dataclass(frozen=True)
class QuadXBaseEnv:
    """Static env configuration + pure reset/step helpers."""

    start_pos: tuple = ((0.0, 0.0, 1.0),)
    start_orn: tuple = ((0.0, 0.0, 0.0),)
    flight_mode: int = 0
    flight_dome_size: float = float("inf")
    max_duration_seconds: float = 10.0
    angle_representation: str = "quaternion"
    agent_hz: int = 30
    noisy_motors: bool = True
    orn_conv: str = "ENU_FLU"
    drone_model: str = "cf2x"
    # route the aviary step through the fused Pallas kernel
    # (ops/pallas_quadx.py — modes 0/8, ENU, detection-grade contact; the
    # motor-noise stream differs from the XLA path, physics identical)
    use_pallas: bool = False

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise AssertionError(
                f"`agent_hz` must be a round denominator of {CONTROL_HZ}."
            )
        assert self.angle_representation in ("euler", "quaternion")
        # materialize the cached param pytree eagerly — building it lazily
        # inside a jit trace would leak tracers into the cache
        _ = self.params

    # ----- static derived quantities -------------------------------------
    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(
            drone_model=self.drone_model,
            control_hz=CONTROL_HZ,
            orn_conv=self.orn_conv,
            noisy_motors=self.noisy_motors,
        )

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def combined_size(self) -> int:
        # attitude + previous action (4) + auxiliary motor state (4)
        return self.attitude_size + 4 + 4

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self) -> tuple[Array, Array]:
        """[±π rate, ±π, ±π, 0..0.8 thrust] (quadx_base_env.py:76-94)."""
        import numpy as np

        high = np.array([np.pi, np.pi, np.pi, 0.8])
        low = np.array([-np.pi, -np.pi, -np.pi, 0.0])
        return low, high

    # ----- shared pieces ---------------------------------------------------
    def attitude_obs(self, state: QuadXEnvState) -> Array:
        """[ang_vel, (quat|euler), lin_vel, lin_pos, action, aux]."""
        view = state.drone.read.view
        parts = [view[..., 0, :]]
        if self.angle_representation == "quaternion":
            parts.append(pm.euler_to_quat(view[..., 1, :]))
        else:
            parts.append(view[..., 1, :])
        parts += [view[..., 2, :], view[..., 3, :], state.action, state.drone.throttle]
        return jnp.concatenate(parts, axis=-1)

    def base_term_trunc_reward(
        self, state: QuadXEnvState, contact: Array
    ) -> QuadXEnvState:
        """collision/out-of-dome → reward −100 + termination; step-count
        truncation (quadx_base_env.py:230-246)."""
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

    def init_env_state(self, key: Array) -> QuadXEnvState:
        """Fresh drone + 10 stabilization aviary steps (quadx_base_env.py:188)."""
        dtype = self.cfg.dtype
        pos = jnp.asarray(self.start_pos[0], dtype=dtype)
        orn = jnp.asarray(self.start_orn[0], dtype=dtype)
        drone = quadx.init_state(self.params, self.cfg, pos, orn)
        drone = quadx.set_mode(drone, self.flight_mode, self.cfg)

        def stab(carry, _):
            drone, key = carry
            key, sub = jax.random.split(key)
            drone, _ = quadx.step(drone, self.params, self.cfg, self.flight_mode, sub)
            return (drone, key), None

        (drone, key), _ = jax.lax.scan(stab, (drone, key), None, length=10)
        false = jnp.zeros((), dtype=bool)
        return QuadXEnvState(
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
        state: QuadXEnvState,
        action: Array,
        task_update: Callable[[QuadXEnvState, Array], QuadXEnvState],
        obs_fn: Callable[[QuadXEnvState], Any],
        extra_info: Callable[[QuadXEnvState], dict[str, Any]] | None = None,
    ) -> tuple[QuadXEnvState, StepOut]:
        """The shared agent-step loop (quadx_base_env.py:248-279).

        ``task_update(state, contact) -> state`` applies base + task-specific
        term/trunc/reward updates after each inner aviary step.
        """
        action = jnp.asarray(action, dtype=self.cfg.dtype)
        state = state.replace(
            action=action,
            # full_like keeps base_step batch-polymorphic: ``step`` works on a
            # single instance under vmap OR directly on a batched state (the
            # pallas fast path needs the whole batch in one kernel call)
            reward=jnp.full_like(state.reward, -0.1),
            drone=state.drone.replace(setpoint=action),
        )

        def inner(st: QuadXEnvState, _):
            done_before = st.termination | st.truncation
            if st.key.ndim == 2:  # direct-batched call: (N, 2) keys
                both = jax.vmap(jax.random.split)(st.key)
                key, sub = both[:, 0], both[0, 1]
            else:
                key, sub = jax.random.split(st.key)
            if self.use_pallas:
                from pyflyt_tpu.ops import pallas_quadx

                drone, contact = pallas_quadx.step(
                    st.drone, self.params, self.cfg, self.flight_mode, sub
                )
            else:
                drone, contact = quadx.step(
                    st.drone, self.params, self.cfg, self.flight_mode, sub
                )
            new_st = task_update(st.replace(drone=drone, key=key), contact)
            # early-exit semantics: freeze everything once done
            st = jax.tree.map(
                lambda new, old: jnp.where(
                    done_before.reshape(
                        done_before.shape + (1,) * (jnp.ndim(old) - done_before.ndim)
                    ),
                    old,
                    new,
                ),
                new_st,
                st,
            )
            return st, None

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
