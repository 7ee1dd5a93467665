"""Packed fast path for the mod-hovering env: physics via the QuadX kernel.

``QuadXModHoveringEnv.step`` is one aviary step + elementwise obs/reward
(envs/quadx_mod/hovering.py:284-346). On the XLA path the aviary step is
the expensive part — at 8192 envs the PPO rollout costs 23 of the 135 ms
train iteration. This wrapper carries the drone in the kernel's folded
``(56, 8, N/8)`` layout across steps and advances physics with ONE
``pallas_call`` per env step (ops/pallas_quadx.packed_step, the generic
non-env-fused variant), while the mod env's observation (rounded state16),
reward shaping, and termination stay in XLA, computed directly from the
kernel's view rows — bit-for-bit from the same formulas
(hovering.py:163-199, 300-346).

Wind: the mod envs draw a random GaussianWind base PER ENV at reset
(hovering.py:209-224). The kernel reads it from rows 51-53
(``wind={'per_env_base': True}``, ops/pallas_quadx.py) in the ENU frame —
the same conversion GaussianWind.__call__ applies for NED envs
(core/wind.py:108-115). ``max_gust=0`` is deterministic and exactly
matches the XLA path; gusty wind matches in distribution with the kernel's
own PRNG stream (the established kernel deviation class, like noisy
motors).

Native-batch env: ``reset(keys)``/``step(state, action)`` take the WHOLE
env batch (no outer vmap) — PPO consumes it via ``native_batch = True``
(rl/ppo.py). Opt-in fast path; the per-env XLA env stays the default.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.quadx_mod.hovering import QuadXModHoveringEnv
from pyflyt_tpu.ops import pallas_quadx as pq


@struct.dataclass
class PackedModHoverState:
    packed: Array  # (56, 8, N/8) drone rows; wind base in rows 51-53
    target_pos: Array  # (N, 3)
    target_psi: Array  # (N,)
    step_count: Array  # (N,) int32
    termination: Array  # (N,) bool
    truncation: Array  # (N,) bool
    collision: Array  # (N,) bool
    state16: Array  # (N, 16)
    key: Array


@struct.dataclass
class PackedAutoResetState:
    """Packed-layout twin of envs/base.py::AutoResetState: the live batch
    plus a cache of pre-computed resets, refreshed every ``refresh`` steps
    under a ``lax.cond`` so the per-step reset recompute (a full vmapped
    base.reset + pack_state — most of the packed rollout cost) amortizes to
    1/refresh.
    Same deviation class as the XLA cached path: an env finishing twice in
    one refresh period restarts from the same initial state; its trajectory
    still diverges through the live per-step kernel noise stream."""

    env_state: PackedModHoverState
    cache_state: PackedModHoverState
    cache_obs: Array
    step_idx: Array  # scalar int32
    key: Array  # PRNG stream for cache refreshes


def _fold(x: Array) -> Array:
    """(k, N) -> (k, 8, N/8)."""
    return x.reshape(x.shape[0], pq.SUBLANES, -1)


def _rows(packed: Array, start: int, k: int) -> Array:
    """(56, 8, N/8) -> (N, k) slice of consecutive rows."""
    r = packed[start : start + k]
    return r.reshape(k, -1).T


@dataclasses.dataclass(frozen=True)
class PackedQuadXModHoveringEnv:
    """Folded-layout twin of QuadXModHoveringEnv (same constructor args)."""

    base: QuadXModHoveringEnv

    native_batch = True  # PPO: skip the per-env vmap (rl/ppo.py)
    # truncation fires only at step_count >= max_steps (step() below), so
    # the slot-bootstrap auto-select may use its one-per-rollout slot
    time_limit_truncation_only = True

    @classmethod
    def create(cls, **kwargs) -> "PackedQuadXModHoveringEnv":
        return cls(base=QuadXModHoveringEnv(**kwargs))

    # ---- forwarded surface used by PPO -------------------------------------
    @property
    def obs_size(self):
        return self.base.obs_size

    @property
    def max_steps(self):
        return self.base.max_steps

    def action_bounds(self):
        return self.base.action_bounds()

    def observation_space_factory(self, spaces):
        return self.base.observation_space_factory(spaces)

    def action_space_factory(self, spaces):
        return self.base.action_space_factory(spaces)

    @property
    def action_space(self):
        return self.base.action_space

    @property
    def observation_space(self):
        return self.base.observation_space

    def _wind_dict(self) -> dict | None:
        b = self.base
        if not b.simulate_wind:
            return None
        return {
            "kind": "gaussian",
            "per_env_base": True,
            "max_gust": float(b.max_gust_strength),
        }

    def _base_rows(self, wind) -> Array:
        """Per-env wind base in the ENU frame the kernel integrates in
        (GaussianWind.__call__: NED components emit x<->y swapped, z
        negated — core/wind.py:108-115)."""
        base = wind.base_wind  # (N, 3) in the env's convention
        if self.base.orn_conv == "NED_FRD":
            base = jnp.stack(
                [base[:, 1], base[:, 0], -base[:, 2]], axis=-1
            )
        return base

    # ---- native-batch env API ----------------------------------------------
    def reset(self, keys: Array) -> tuple[PackedModHoverState, Array]:
        n = keys.shape[0]
        assert n % pq.SUBLANES == 0, (
            f"the packed env folds the batch to ({pq.SUBLANES}, N/"
            f"{pq.SUBLANES}) rows: batch size must be divisible by "
            f"{pq.SUBLANES}, got {n} (e.g. round --num_envs/--eval_episodes "
            f"up, or use the XLA QuadXModHoveringEnv)"
        )
        st, obs = jax.vmap(self.base.reset)(keys)
        packed = pq.pack_state(st.drone, self.base.flight_mode)
        if self.base.simulate_wind:
            packed = packed.at[pq._WBASE : pq._WBASE + 3].set(
                _fold(self._base_rows(st.wind).T)
            )
        n = keys.shape[0]
        state = PackedModHoverState(
            packed=packed,
            target_pos=st.target_pos,
            target_psi=st.target_psi,
            step_count=jnp.zeros((n,), jnp.int32),
            termination=jnp.zeros((n,), bool),
            truncation=jnp.zeros((n,), bool),
            collision=jnp.zeros((n,), bool),
            state16=st.state16,
            key=jax.random.fold_in(keys[0], 0x90DE),
        )
        return state, obs

    def step(
        self, state: PackedModHoverState, action: Array
    ) -> tuple[PackedModHoverState, StepOut]:
        b = self.base
        dtype = b.cfg.dtype
        done_before = state.termination | state.truncation

        action = b._denormalize_action(jnp.asarray(action, dtype))
        key, sub = jax.random.split(state.key)
        seed = jax.random.randint(sub, (), 0, 2**31 - 1)

        flat = state.packed.reshape(state.packed.shape[0], -1)
        flat = flat.at[pq._SP : pq._SP + 4].set(action.T)
        out = pq.packed_step(
            _fold(flat),
            seed,
            b.params,
            b.cfg,
            mode=b.flight_mode,
            noisy=b.noisy_motors,
            wind=self._wind_dict(),
        )
        contact = _rows(out, pq._CON + 1, 1)[:, 0] > 0.5

        # state16 from the kernel's view rows (hovering.py:167-190)
        view = _rows(out, pq._VIEW, 12)
        ang_vel = view[:, 0:3]
        ang_pos = pm.wrap_angle(view[:, 3:6])
        lin_vel = view[:, 6:9]
        lin_pos = view[:, 9:12]
        psi_err = pm.wrap_angle(state.target_psi - ang_pos[:, 2])
        pos_err = state.target_pos - lin_pos
        state16 = b._round3(
            jnp.concatenate(
                [lin_pos, lin_vel, ang_pos, ang_vel, pos_err,
                 psi_err[:, None]],
                axis=-1,
            )
        )

        # reward / termination (hovering.py:300-315)
        truncation = state.step_count >= b.max_steps
        err_dist = jnp.linalg.norm(state16[:, 12:15], axis=-1)
        err_vel = jnp.linalg.norm(state16[:, 3:6], axis=-1)
        err_psi = jnp.abs(state16[:, 15])
        err_ang_vel = jnp.linalg.norm(state16[:, 9:12], axis=-1)
        reward = 35.0 + (
            -b.alpha * err_dist
            - b.beta * err_vel
            - b.gamma * err_psi
            - b.delta * err_ang_vel
        )
        reward = jnp.where(contact, -1000.0, reward).astype(dtype)

        new_state = PackedModHoverState(
            packed=out,
            target_pos=state.target_pos,
            target_psi=state.target_psi,
            step_count=state.step_count + 1,
            # already-done lanes freeze their flags too (the XLA env's
            # tree_select freeze, hovering.py:333-336): without the
            # ~done_before mask a post-done contact would flip termination
            # when stepping without auto-reset
            termination=state.termination | (contact & ~done_before),
            truncation=state.truncation | (truncation & ~done_before),
            collision=state.collision | contact,
            state16=state16,
            key=key,
        )
        # done-freeze (hovering.py:333-336): finished lanes keep their state
        mask = _fold(done_before[None, :].astype(out.dtype))
        frozen = jnp.where(mask > 0.5, state.packed, out)
        new_state = new_state.replace(
            packed=frozen,
            step_count=jnp.where(
                done_before, state.step_count, new_state.step_count
            ),
            state16=jnp.where(
                done_before[:, None], state.state16, new_state.state16
            ),
            collision=jnp.where(
                done_before, state.collision, new_state.collision
            ),
        )
        obs = b._normalize_obs(new_state.state16)
        return new_state, StepOut(
            obs=obs,
            reward=jnp.where(done_before, 0.0, reward).astype(dtype),
            termination=new_state.termination,
            truncation=new_state.truncation,
            info={
                "collision": new_state.collision,
                "out_of_bounds": jnp.zeros_like(new_state.collision),
                "env_complete": jnp.zeros_like(new_state.collision),
            },
        )

    def autoreset_step(
        self, state: PackedModHoverState, action: Array
    ) -> tuple[PackedModHoverState, StepOut]:
        """Exact-semantics auto-reset (envs/base.py autoreset_step on the
        packed layout): finished lanes are replaced by fresh resets; the
        pre-reset observation is surfaced as ``terminal_observation``."""
        state, out = self.step(state, action)
        done = out.termination | out.truncation
        n = done.shape[0]
        key, sub = jax.random.split(state.key)
        reset_state, reset_obs = self.reset(jax.random.split(sub, n))
        mask = _fold(done[None, :].astype(state.packed.dtype))
        merged = PackedModHoverState(
            packed=jnp.where(mask > 0.5, reset_state.packed, state.packed),
            target_pos=jnp.where(
                done[:, None], reset_state.target_pos, state.target_pos
            ),
            target_psi=jnp.where(
                done, reset_state.target_psi, state.target_psi
            ),
            step_count=jnp.where(done, 0, state.step_count),
            termination=jnp.where(done, False, state.termination),
            truncation=jnp.where(done, False, state.truncation),
            collision=jnp.where(done, False, state.collision),
            state16=jnp.where(
                done[:, None], reset_state.state16, state.state16
            ),
            key=key,
        )
        obs = jnp.where(done[:, None], reset_obs, out.obs)
        info = dict(out.info)
        info["terminal_observation"] = out.obs
        return merged, StepOut(
            obs=obs,
            reward=out.reward,
            termination=out.termination,
            truncation=out.truncation,
            info=info,
        )

    # ---- amortized auto-reset (the fast path; envs/base.py semantics) -------
    def _substitute(
        self,
        state: PackedModHoverState,
        reset_state: PackedModHoverState,
        done: Array,
    ) -> PackedModHoverState:
        """done lanes take ``reset_state``'s entries; the live key stream
        stays (it seeds the kernel's per-step noise for the whole batch)."""
        mask = _fold(done[None, :].astype(state.packed.dtype))
        sel = lambda r, s: jnp.where(done, r, s)  # noqa: E731
        return PackedModHoverState(
            packed=jnp.where(mask > 0.5, reset_state.packed, state.packed),
            target_pos=jnp.where(
                done[:, None], reset_state.target_pos, state.target_pos
            ),
            target_psi=sel(reset_state.target_psi, state.target_psi),
            step_count=sel(reset_state.step_count, state.step_count),
            termination=sel(reset_state.termination, state.termination),
            truncation=sel(reset_state.truncation, state.truncation),
            collision=sel(reset_state.collision, state.collision),
            state16=jnp.where(
                done[:, None], reset_state.state16, state.state16
            ),
            key=state.key,
        )

    def cached_autoreset_init(
        self, keys: Array
    ) -> tuple[PackedAutoResetState, Array]:
        """Resets the batch and fills the reset cache (autoreset_init)."""
        state, obs = self.reset(keys)
        cache_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0x5EED))(keys)
        cache_state, cache_obs = self.reset(cache_keys)
        return (
            PackedAutoResetState(
                env_state=state,
                cache_state=cache_state,
                cache_obs=cache_obs,
                step_idx=jnp.zeros((), jnp.int32),
                key=jax.random.fold_in(keys[0], 0xCACE),
            ),
            obs,
        )

    def cached_autoreset_step(
        self, ars: PackedAutoResetState, action: Array, refresh: int = 64
    ) -> tuple[PackedAutoResetState, StepOut]:
        """Step with cached auto-reset (base.py::cached_autoreset_step on the
        folded layout): finished lanes substitute their cached reset; the
        whole cache regenerates every ``refresh`` steps under a cond."""
        state, out = self.step(ars.env_state, action)
        done = out.termination | out.truncation

        state = self._substitute(state, ars.cache_state, done)
        terminal_obs = out.obs
        obs = jnp.where(done[:, None], ars.cache_obs, out.obs)

        n = done.shape[0]
        key, sub = jax.random.split(ars.key)

        def do_refresh(_):
            return self.reset(jax.random.split(sub, n))

        def keep(_):
            return ars.cache_state, ars.cache_obs

        cache_state, cache_obs = jax.lax.cond(
            ars.step_idx % refresh == refresh - 1, do_refresh, keep, None
        )
        ars = PackedAutoResetState(
            env_state=state,
            cache_state=cache_state,
            cache_obs=cache_obs,
            step_idx=ars.step_idx + 1,
            key=key,
        )
        return ars, out.replace(
            obs=obs, info={**out.info, "terminal_observation": terminal_obs}
        )
