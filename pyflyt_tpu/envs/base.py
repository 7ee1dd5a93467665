"""Functional environment protocol + batching/auto-reset helpers.

The reference's Gymnasium envs rebuild the whole PyBullet Aviary every episode
(/root/reference/PyFlyt/gym_envs/quadx_envs/quadx_base_env.py:140-191). Here
``reset`` is a pure function of a PRNG key and ``step`` a pure transition, so
auto-resetting vectorized rollouts run entirely on-device under one jit.
"""

from __future__ import annotations

from typing import Any, Protocol

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from pyflyt_tpu.core.struct import tree_select  # noqa: F401
from jax import Array


@struct.dataclass
class StepOut:
    """Transition outputs (all batched like the state)."""

    obs: Any  # Array or dict of Arrays
    reward: Array
    termination: Array
    truncation: Array
    info: dict[str, Array]


class FunctionalEnv(Protocol):
    """Structural type implemented by every env module."""

    def reset(self, key: Array) -> tuple[Any, Any]: ...

    def step(self, state: Any, action: Array) -> tuple[Any, StepOut]: ...


# ---------------------------------------------------------------------------
# vectorization + auto-reset
# ---------------------------------------------------------------------------


def vec_reset(env: FunctionalEnv, keys: Array) -> tuple[Any, Any]:
    """Resets a batch of env instances from a batch of keys."""
    return jax.vmap(env.reset)(keys)


def vec_step(env: FunctionalEnv, state: Any, action: Array) -> tuple[Any, StepOut]:
    """Steps a batch of env instances."""
    return jax.vmap(env.step)(state, action)


def autoreset_step(
    env: FunctionalEnv, state: Any, action: Array
) -> tuple[Any, StepOut]:
    """Vectorized step with masked auto-reset on termination|truncation.

    Replaces SB3's SubprocVecEnv episode handling
    (/root/reference/PyFlyt/rl_training/hovering/training.py:159-164):
    finished instances are reset in-place with fresh PRNG streams; the
    returned ``StepOut`` reflects the *pre-reset* transition (standard vec-env
    convention: the final obs of an episode is replaced by the next episode's
    initial obs, and reward/term/trunc describe the finished transition).

    NOTE: this recomputes ``env.reset`` for the whole batch every step (the
    vmap cost model), which for envs with reset-time stabilization rollouts
    is ~3-4× the cost of the step itself. The fast path is the cached
    variant below (``autoreset_init`` / ``cached_autoreset_step``).
    """
    state, out = jax.vmap(env.step)(state, action)
    done = out.termination | out.truncation

    reset_keys = jax.vmap(lambda s: jax.random.fold_in(s.key, 1))(state)
    reset_state, reset_obs = jax.vmap(env.reset)(reset_keys)

    state = tree_select(done, reset_state, state)
    terminal_obs = out.obs  # pre-reset obs (SB3's "terminal_observation")
    obs = tree_select(done, reset_obs, out.obs)
    return state, out.replace(
        obs=obs, info={**out.info, "terminal_observation": terminal_obs}
    )


# ---------------------------------------------------------------------------
# amortized auto-reset (the fast path)
# ---------------------------------------------------------------------------


@struct.dataclass
class AutoResetState:
    """Env batch + a per-env cache of pre-computed reset states.

    Instead of recomputing ``env.reset`` for every env on every step, the
    whole cache is refreshed once every ``refresh_period`` steps (under a
    ``lax.cond``, so the reset work executes on 1/period of the steps) and
    finished envs substitute their cached entry. Each cached reset was
    generated from a fresh PRNG key drawn independently of the episode
    outcome, so the reset distribution is identical to the exact path; the
    only deviation is that an env finishing twice within one refresh period
    reuses the same *initial* state — its PRNG key is re-derived on
    consumption, so the subsequent trajectory still diverges.

    The periodic-full-refresh structure is deliberate for multi-chip meshes:
    refreshing sharded cache entries at a dynamic round-robin offset makes
    XLA all-gather the cache across devices every step; the cond'd full
    refresh keeps every collective out of the rollout (each shard resets its
    own envs — see docs/artifacts/mesh_collectives.json).
    """

    env_state: Any
    cache_state: Any
    cache_obs: Any
    step_idx: Array  # int32
    key: Array  # PRNG stream for cache refreshes


def _unalias(obs: Any) -> Any:
    """Copies ``obs`` out of any buffers it shares with the env state.

    Dict-obs envs return state fields directly (e.g. QuadXGates
    ``target_deltas``), so a cached ``(state, obs)`` pair holds the SAME
    buffer at two pytree leaves — which breaks donated jits ("attempt to
    donate the same buffer twice", rl/train.py donates the runner).
    ``optimization_barrier`` forces distinct values/buffers both eagerly
    and under jit (plain identities would be CSE'd back together).
    """
    return jax.lax.optimization_barrier(obs)


def autoreset_init(env: FunctionalEnv, keys: Array) -> tuple[AutoResetState, Any]:
    """Resets the batch and fills the reset cache."""
    state, obs = jax.vmap(env.reset)(keys)
    cache_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0x5EED))(keys)
    cache_state, cache_obs = jax.vmap(env.reset)(cache_keys)
    return (
        AutoResetState(
            env_state=state,
            cache_state=cache_state,
            cache_obs=_unalias(cache_obs),
            step_idx=jnp.zeros((), jnp.int32),
            key=jax.random.fold_in(keys[0], 0xCACE),
        ),
        obs,
    )


def cached_autoreset_step(
    env: FunctionalEnv,
    ars: AutoResetState,
    action: Array,
    refresh: int = 64,
    step_fn=None,
) -> tuple[AutoResetState, StepOut]:
    """Vectorized step with cached auto-reset (see :class:`AutoResetState`).

    ``refresh`` is the refresh PERIOD: the full cache regenerates every
    ``refresh`` steps inside a ``lax.cond`` — amortized reset cost is
    ``1/refresh`` of the exact path, with zero cross-device collectives.

    ``step_fn``: optional batched ``(states, actions) -> (states, StepOut)``
    override. Defaults to ``vmap(env.step)``; batch-polymorphic envs (e.g.
    the QuadX envs' pallas fast path) can pass ``env.step`` directly so the
    whole batch enters one kernel.
    """
    if step_fn is None:
        step_fn = jax.vmap(env.step)
    state, out = step_fn(ars.env_state, action)
    done = out.termination | out.truncation

    # substitute cached resets for finished envs (key re-derived so repeat
    # consumers of a stale slot still diverge)
    fresh = ars.cache_state
    fresh = fresh.replace(
        key=jax.vmap(lambda k: jax.random.fold_in(k, ars.step_idx))(fresh.key)
    )

    state = tree_select(done, fresh, state)
    terminal_obs = out.obs  # pre-reset obs (SB3's "terminal_observation")
    obs = tree_select(done, ars.cache_obs, out.obs)

    # periodic full cache refresh (collective-free on an env-sharded mesh)
    num_envs = done.shape[0]
    key, sub = jax.random.split(ars.key)

    def do_refresh(_):
        new_keys = jax.random.split(sub, num_envs)
        st, ob = jax.vmap(env.reset)(new_keys)
        return st, _unalias(ob)

    def keep(_):
        return ars.cache_state, ars.cache_obs

    cache_state, cache_obs = jax.lax.cond(
        ars.step_idx % refresh == refresh - 1, do_refresh, keep, None
    )

    ars = AutoResetState(
        env_state=state,
        cache_state=cache_state,
        cache_obs=cache_obs,
        step_idx=ars.step_idx + 1,
        key=key,
    )
    return ars, out.replace(
        obs=obs, info={**out.info, "terminal_observation": terminal_obs}
    )
