"""Self-play adapter: the packed dogfight as a native-batch 1-agent env.

The reference ships the dogfight as a PettingZoo env with NO training
pipeline (/root/reference/PyFlyt/pz_envs/fixedwing_envs/
ma_fixedwing_dogfight_env.py); this adapter makes the fused-kernel
dogfight (envs/packed_dogfight.py) trainable
by the standard single-agent PPO via SELF-PLAY: both drones of every
arena are rows of one flat agent batch driven by the same policy.

Mapping (B = 2·N agent rows over N arenas, arena-major pairs):

- ``reset(keys (B, ...))`` uses the first N keys to spawn N arenas and
  returns the (B, 30) observation block.
- ``step(state, actions (B, A))`` folds actions back to (N, 2, A), runs
  the ONE-``pallas_call`` arena step, and reports per-ROW flags:
  a row TERMINATES on its own death (health 0 / collision / OOB /
  lethal-cone loss) and TRUNCATES on time-limit or when its arena ends
  because the PARTNER died — the surviving agent's episode is cut short
  through no terminal state of its own, which is exactly the
  time-limit-style bootstrap case (its pre-reset observation is
  surfaced as ``terminal_observation``).
- ``autoreset_step`` resets a whole ARENA as soon as either row is done
  (a dogfight with a dead opponent has no further learning signal; the
  reference's PZ loop likewise ends the episode for everyone once
  ``any`` terminal agent remains unstepped).

PPO notes: use ``PPOConfig(slot_bootstrap=False)`` — arenas can end and
reset several times inside one rollout (early policies crash/flee within
seconds), which violates the slot path's one-truncation-per-rollout
invariant. ``cached_reset_refresh>0`` selects the amortized arena-spawn
pool (``cached_autoreset_init/step`` below — the exact path recomputes
the XLA reset every step, which dominates its cost); 0 keeps exact
per-step resets.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.packed_dogfight import (
    PackedDogfightEnvState,
    PackedMAFixedwingDogfightEnv,
)


@struct.dataclass
class SelfPlayState:
    inner: PackedDogfightEnvState
    key: Array


@struct.dataclass
class SelfPlayAutoResetState:
    """Carry for the amortized (cached) arena-reset fast path."""

    env_state: SelfPlayState
    cache_inner: PackedDogfightEnvState
    cache_obs: Array  # (N, 2, obs)
    step_idx: Array
    key: Array


@dataclasses.dataclass(frozen=True)
class SelfPlayDogfightEnv:
    """Flat-batch self-play view over ``PackedMAFixedwingDogfightEnv``."""

    penv: PackedMAFixedwingDogfightEnv = dataclasses.field(
        default_factory=PackedMAFixedwingDogfightEnv
    )

    native_batch = True
    # Partner death truncates a row at ANY step, arbitrarily often per
    # rollout — PPO's slot_bootstrap auto-select must stay off (its slot
    # holds one truncation per env per rollout; see rl/ppo.py::_use_slot).
    time_limit_truncation_only = False

    @property
    def base(self):
        return self.penv.base

    @property
    def max_steps(self) -> int:
        return self.base.max_steps

    @property
    def obs_size(self) -> int:
        return self.base.obs_size

    def action_bounds(self):
        return self.base.action_bounds()

    # ------------------------------------------------------------------ api
    def reset(self, keys: Array) -> tuple[SelfPlayState, Array]:
        """``keys``: (B, ...) PRNG keys, B = 2N agent rows, N % 8 == 0."""
        b = keys.shape[0]
        assert b % 2 == 0, b
        n = b // 2
        inner, obs = self.penv.reset(keys[:n])
        state = SelfPlayState(
            inner=inner, key=jax.random.fold_in(keys[0], 0x5E1F)
        )
        return state, obs.reshape(b, -1)

    def _flat(self, x):  # (N, 2, ...) -> (B, ...)
        return x.reshape((x.shape[0] * 2,) + x.shape[2:])

    def step(
        self, state: SelfPlayState, actions: Array
    ) -> tuple[SelfPlayState, StepOut]:
        """Plain step (no arena reset): per-row flags as documented above."""
        b = actions.shape[0]
        inner, out = self.penv.step(
            state.inner, actions.reshape(b // 2, 2, -1)
        )
        own_done = out.termination | out.truncation  # (N, 2)
        match_done = jnp.any(own_done, axis=1)  # (N,)
        termination = out.termination
        truncation = out.truncation | (match_done[:, None] & ~own_done)
        # healths comes (N, 2, 2) broadcast over agents; row i keeps its own
        own_health = out.info["healths"][:, 0, :]  # (N, 2)
        return SelfPlayState(inner=inner, key=state.key), StepOut(
            obs=self._flat(out.obs),
            reward=self._flat(out.reward),
            termination=self._flat(termination),
            truncation=self._flat(truncation),
            info={"health": self._flat(own_health)},
        )

    def _splice(self, inner, reset_inner, match_done):
        """done arenas take ``reset_inner``'s entries (one arena per packed
        lane element); the live key stream stays."""
        maskf = match_done.astype(inner.packed.dtype).reshape(
            1, inner.packed.shape[1], -1
        )
        return PackedDogfightEnvState(
            packed=jnp.where(maskf > 0.5, reset_inner.packed, inner.packed),
            key=inner.key,
            alive=jnp.where(
                match_done[:, None], reset_inner.alive, inner.alive
            ),
            current_actions=jnp.where(
                match_done[:, None, None],
                reset_inner.current_actions,
                inner.current_actions,
            ),
            past_actions=jnp.where(
                match_done[:, None, None],
                reset_inner.past_actions,
                inner.past_actions,
            ),
        )

    def autoreset_step(
        self, state: SelfPlayState, actions: Array
    ) -> tuple[SelfPlayState, StepOut]:
        """Step + arena-level exact auto-reset (fresh spawn per done arena);
        pre-reset observations surface as ``terminal_observation``."""
        b = actions.shape[0]
        n = b // 2
        new_state, out = self.step(state, actions)
        # arena is done when either row is
        row_done = out.termination | out.truncation  # (B,)
        match_done = jnp.any(row_done.reshape(n, 2), axis=1)  # (N,)

        key, sub = jax.random.split(state.key)
        reset_inner, reset_obs = self.penv.reset(jax.random.split(sub, n))
        merged = self._splice(new_state.inner, reset_inner, match_done)
        obs = jnp.where(
            match_done[:, None, None],
            reset_obs,
            out.obs.reshape(n, 2, -1),
        ).reshape(b, -1)
        info = dict(out.info)
        info["terminal_observation"] = out.obs
        return SelfPlayState(inner=merged, key=key), out.replace(
            obs=obs, info=info
        )

    # ---- amortized auto-reset (base.py cached semantics, arena-level) ------
    def cached_autoreset_init(
        self, keys: Array
    ) -> tuple[SelfPlayAutoResetState, Array]:
        """Resets the batch AND fills a cached spawn pool: done arenas
        substitute their cached spawn instead of recomputing the XLA reset
        every step (the exact path's dominant cost — docs/PERF.md self-play
        section); the pool regenerates every ``refresh`` steps."""
        state, obs = self.reset(keys)
        n = keys.shape[0] // 2
        cache_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0x5EED))(
            keys[:n]
        )
        cache_inner, cache_obs = self.penv.reset(cache_keys)
        return (
            SelfPlayAutoResetState(
                env_state=state,
                cache_inner=cache_inner,
                cache_obs=cache_obs,
                step_idx=jnp.zeros((), jnp.int32),
                key=jax.random.fold_in(keys[0], 0xCACE),
            ),
            obs,
        )

    def cached_autoreset_step(
        self, ars: SelfPlayAutoResetState, actions: Array, refresh: int = 64
    ) -> tuple[SelfPlayAutoResetState, StepOut]:
        b = actions.shape[0]
        n = b // 2
        state, out = self.step(ars.env_state, actions)
        row_done = out.termination | out.truncation
        match_done = jnp.any(row_done.reshape(n, 2), axis=1)

        merged = self._splice(state.inner, ars.cache_inner, match_done)
        obs = jnp.where(
            match_done[:, None, None],
            ars.cache_obs,
            out.obs.reshape(n, 2, -1),
        ).reshape(b, -1)

        key, sub = jax.random.split(ars.key)

        def do_refresh(_):
            return self.penv.reset(jax.random.split(sub, n))

        def keep(_):
            return ars.cache_inner, ars.cache_obs

        cache_inner, cache_obs = jax.lax.cond(
            ars.step_idx % refresh == refresh - 1, do_refresh, keep, None
        )
        info = dict(out.info)
        info["terminal_observation"] = out.obs
        return (
            SelfPlayAutoResetState(
                env_state=SelfPlayState(inner=merged, key=state.key),
                cache_inner=cache_inner,
                cache_obs=cache_obs,
                step_idx=ars.step_idx + 1,
                key=key,
            ),
            out.replace(obs=obs, info=info),
        )
