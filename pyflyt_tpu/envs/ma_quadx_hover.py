"""Multi-agent QuadX Hover (PettingZoo-style, functional core).

Re-implements /root/reference/PyFlyt/pz_envs/quadx_envs/ma_quadx_hover_env.py
+ its base (ma_quadx_base_env.py) with a fixed agent axis and an ``alive``
mask instead of the reference's mutable agent list (culling happens between
agent steps — ma_quadx_base_env.py:361-366).

Semantics preserved:
- per inner aviary step, every (step-start-alive) agent accumulates
  reward/termination: −100 per inner step on collision or out-of-dome, plus
  the dense shaping ``1 − ‖pos − start‖ − 0.1·‖(roll, pitch)‖``
  (ma_quadx_hover_env.py:157-177) — no early exit within the agent step
- observations reflect the post-step state with the *previous* step's actions
  (the reference's ``past_actions`` double buffer, ma_quadx_base_env.py:317)
- drone-drone collisions: the reference relies on PyBullet box contacts; here
  a sphere-sphere proximity test at the vehicles' bounding radius (the
  0.09×0.09×0.02 cf2x collision box ⇒ r ≈ 0.065).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.core import math as pm
from pyflyt_tpu.models import quadx

CONTROL_HZ = 120


@struct.dataclass
class MAQuadXState:
    drones: quadx.QuadXState  # batched (n_agents,)
    key: Array
    step_count: Array  # scalar int32
    alive: Array  # (n,) bool — agents still in self.agents
    current_actions: Array  # (n, 4)
    past_actions: Array  # (n, 4)


@struct.dataclass
class MAStepOut:
    """Fixed-shape multi-agent transition (dict conversion in the PZ shim)."""

    obs: Array  # (n, obs_dim)
    reward: Array  # (n,)
    termination: Array  # (n,)
    truncation: Array  # (n,)
    agents_mask: Array  # (n,) agents alive at step START (have valid outputs)
    info: dict[str, Array]


_DEFAULT_START = (
    (-1.0, -1.0, 1.0), (1.0, -1.0, 1.0), (-1.0, 1.0, 1.0), (1.0, 1.0, 1.0),
)


@dataclasses.dataclass(frozen=True)
class MAQuadXHoverEnv:
    render_half_extents = (0.12, 0.12, 0.04)  # quad body box for renders
    start_pos: tuple = _DEFAULT_START
    start_orn: tuple = ((0.0, 0.0, 0.0),) * 4
    flight_mode: int = 0
    flight_dome_size: float = 10.0
    max_duration_seconds: float = 10.0
    angle_representation: str = "euler"  # the MA default (ma_quadx_base_env.py:28)
    agent_hz: int = 40
    sparse_reward: bool = False
    collision_radius: float = 0.065

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise AssertionError(
                f"`agent_hz` must be a round denominator of {CONTROL_HZ}."
            )
        assert self.angle_representation in ("euler", "quaternion")
        _ = self.params

    # ----- static -----------------------------------------------------------
    @property
    def num_agents(self) -> int:
        return len(self.start_pos)

    @property
    def possible_agents(self) -> list[str]:
        return [f"uav_{i}" for i in range(self.num_agents)]

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> quadx.QuadXConfig:
        return quadx.QuadXConfig(control_hz=CONTROL_HZ)

    @functools.cached_property
    def params(self) -> quadx.QuadXParams:
        return quadx.build_params(self.cfg)

    @property
    def attitude_size(self) -> int:
        return 13 if self.angle_representation == "quaternion" else 12

    @property
    def obs_size(self) -> int:
        # attitude + aux (4) + past action (4) + own start pos (3)
        return self.attitude_size + 4 + 4 + 3

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self):
        high = np.array([np.pi, np.pi, np.pi, 0.8])
        low = np.array([-np.pi, -np.pi, -np.pi, 0.0])
        return low, high

    # ----- helpers ----------------------------------------------------------
    def _start_pos_arr(self) -> Array:
        return jnp.asarray(self.start_pos, dtype=self.cfg.dtype)

    def _collisions(self, state: quadx.QuadXState, model_contact: Array) -> Array:
        """Ground contact (model) | pairwise drone proximity."""
        pos = state.body.pos  # (n, 3) ENU
        diff = pos[:, None, :] - pos[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        n = pos.shape[0]
        d2 = d2 + jnp.eye(n, dtype=d2.dtype) * 1e6
        mutual = jnp.any(d2 < (2.0 * self.collision_radius) ** 2, axis=-1)
        return model_contact | mutual

    def _obs(self, state: MAQuadXState) -> Array:
        view = state.drones.read.view  # (n, 4, 3)
        parts = [view[..., 0, :]]
        if self.angle_representation == "quaternion":
            parts.append(pm.euler_to_quat(view[..., 1, :]))
        else:
            parts.append(view[..., 1, :])
        parts += [
            view[..., 2, :],
            view[..., 3, :],
            state.drones.throttle,  # aux
            state.past_actions,
            self._start_pos_arr(),
        ]
        return jnp.concatenate(parts, axis=-1)

    # ----- API --------------------------------------------------------------
    def reset(self, key: Array) -> tuple[MAQuadXState, Array]:
        pos = self._start_pos_arr()
        orn = jnp.asarray(self.start_orn, dtype=self.cfg.dtype)
        drones = quadx.init_state(self.params, self.cfg, pos, orn)
        drones = quadx.set_mode(drones, self.flight_mode, self.cfg)

        def stab(carry, _):
            drones, key = carry
            key, sub = jax.random.split(key)
            drones, _ = quadx.step(
                drones, self.params, self.cfg, self.flight_mode, sub
            )
            return (drones, key), None

        (drones, key), _ = jax.lax.scan(stab, (drones, key), None, length=10)
        n = self.num_agents
        state = MAQuadXState(
            drones=drones,
            key=key,
            step_count=jnp.zeros((), jnp.int32),
            alive=jnp.ones((n,), bool),
            current_actions=jnp.zeros((n, 4), self.cfg.dtype),
            past_actions=jnp.zeros((n, 4), self.cfg.dtype),
        )
        return state, self._obs(state)

    def step(self, state: MAQuadXState, actions: Array) -> tuple[MAQuadXState, MAStepOut]:
        """``actions``: (n, 4); rows of step-start-dead agents are ignored
        (zeroed, as the reference does for missing dict keys)."""
        actions = jnp.asarray(actions, dtype=self.cfg.dtype)
        agents_mask = state.alive
        actions = jnp.where(agents_mask[:, None], actions, 0.0)
        state = state.replace(
            past_actions=state.current_actions,
            current_actions=actions,
            drones=state.drones.replace(setpoint=actions),
        )

        n = self.num_agents
        start = self._start_pos_arr()

        def inner(carry, _):
            st, term, trunc, reward = carry
            key, sub = jax.random.split(st.key)
            drones, contact = quadx.step(
                st.drones, self.params, self.cfg, self.flight_mode, sub
            )
            st = st.replace(drones=drones, key=key)

            collision = self._collisions(drones, contact)
            view = drones.read.view
            lin_pos = view[..., 3, :]
            oob = jnp.linalg.norm(lin_pos, axis=-1) > self.flight_dome_size

            rew = jnp.zeros((n,), self.cfg.dtype)
            rew = rew - 100.0 * collision - 100.0 * oob
            if not self.sparse_reward:
                lin_dist = jnp.linalg.norm(lin_pos - start, axis=-1)
                ang_dist = jnp.linalg.norm(view[..., 1, :2], axis=-1)
                rew = rew - (lin_dist + 0.1 * ang_dist) + 1.0

            term = term | collision | oob
            trunc = trunc | (st.step_count > self.max_steps)
            reward = reward + rew
            return (st, term, trunc, reward), (collision, oob)

        zeros_b = jnp.zeros((n,), bool)
        zeros_f = jnp.zeros((n,), self.cfg.dtype)
        (state, term, trunc, reward), (collisions, oobs) = jax.lax.scan(
            inner, (state, zeros_b, zeros_b, zeros_f), None,
            length=self.env_step_ratio,
        )
        state = state.replace(
            step_count=state.step_count + 1,
            alive=state.alive & ~(term | trunc),
        )
        out = MAStepOut(
            obs=self._obs(state),
            reward=reward,
            termination=term,
            truncation=trunc,
            agents_mask=agents_mask,
            info={
                "collision": jnp.any(collisions, axis=0),
                "out_of_bounds": jnp.any(oobs, axis=0),
            },
        )
        return state, out
