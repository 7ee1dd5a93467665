"""Packed mod-hovering env vs the XLA env (interpret mode on CPU).

Deterministic configuration (noisy_motors=False, max_gust=0): the packed
path must track the vmapped XLA env exactly — same reset keys produce the
same initial states and per-env wind bases, and the kernel's gaussian wind
with max_gust=0 is the deterministic base-only path
(ops/pallas_quadx.py::_build_kernel docstring). The compiled kernel is
checked on the GPU by chip_smoke.py like the other fused envs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyflyt_tpu.envs.quadx_mod import QuadXModHoveringEnv
from pyflyt_tpu.envs.quadx_mod.packed_hovering import (
    PackedQuadXModHoveringEnv,
)


N = 32
KW = dict(
    flight_mode=9, orn_conv="NED_FRD", control_hz=40,
    simulate_wind=True, max_gust_strength=0.0, noisy_motors=False,
)


def _run(steps=6):
    base = QuadXModHoveringEnv(**KW)
    packed = PackedQuadXModHoveringEnv.create(**KW)
    keys = jax.random.split(jax.random.PRNGKey(0), N)

    ref_state, ref_obs = jax.vmap(base.reset)(keys)
    pk_state, pk_obs = packed.reset(keys)
    np.testing.assert_allclose(np.asarray(pk_obs), np.asarray(ref_obs))

    act = jnp.tile(jnp.asarray([0.01, -0.01, 0.0, 0.1]), (N, 1))
    ref_step = jax.jit(jax.vmap(base.step))
    pk_step = jax.jit(packed.step)
    for i in range(steps):
        ref_state, ref_out = ref_step(ref_state, act)
        pk_state, pk_out = pk_step(pk_state, act)
        yield i, ref_out, pk_out


def test_packed_matches_xla_env():
    for i, ref_out, pk_out in _run():
        np.testing.assert_allclose(
            np.asarray(pk_out.obs), np.asarray(ref_out.obs),
            atol=2e-3, err_msg=f"obs step {i}",
        )
        np.testing.assert_allclose(
            np.asarray(pk_out.reward), np.asarray(ref_out.reward),
            atol=5e-2, err_msg=f"reward step {i}",
        )
        np.testing.assert_array_equal(
            np.asarray(pk_out.termination), np.asarray(ref_out.termination),
            err_msg=f"termination step {i}",
        )


def test_packed_wind_base_actually_blows():
    """Per-env wind rows reach the drag term: zero-wind and windy packed
    envs diverge (same everything else)."""
    kw = dict(KW)
    packed_w = PackedQuadXModHoveringEnv.create(**kw)
    kw2 = dict(kw)
    kw2["simulate_wind"] = False
    packed_0 = PackedQuadXModHoveringEnv.create(**kw2)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    sw, _ = packed_w.reset(keys)
    s0, _ = packed_0.reset(keys)
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.1]), (N, 1))
    for _ in range(4):
        sw, ow = jax.jit(packed_w.step)(sw, act)
        s0, o0 = jax.jit(packed_0.step)(s0, act)
    assert float(jnp.max(jnp.abs(ow.obs - o0.obs))) > 1e-4


def test_packed_autoreset_step():
    """autoreset_step: finished lanes restart (step_count 0, fresh obs) and
    surface terminal_observation."""
    packed = PackedQuadXModHoveringEnv.create(
        **{**KW, "max_duration_seconds": 0.1}  # 5 steps at 40 Hz
    )
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    state, obs = packed.reset(keys)
    act = jnp.zeros((N, 4))
    step = jax.jit(packed.autoreset_step)
    saw_done = False
    for _ in range(8):
        state, out = step(state, act)
        assert "terminal_observation" in out.info
        if bool(jnp.any(out.termination | out.truncation)):
            saw_done = True
    assert saw_done
    # every lane that truncated was reset: step_count below the horizon
    assert int(jnp.max(state.step_count)) <= packed.base.max_steps + 1
    assert np.all(np.isfinite(np.asarray(out.obs)))


def test_ppo_native_batch_trains():
    """PPO consumes the packed env via native_batch: one train iteration
    runs, metrics finite, env-provided auto-reset in the rollout."""
    import dataclasses as dc

    from pyflyt_tpu.rl.ppo import PPO, PPOConfig

    env = PackedQuadXModHoveringEnv.create(
        **{**KW, "max_duration_seconds": 0.5}
    )
    cfg = PPOConfig(num_envs=16, rollout_steps=8, num_epochs=2,
                    num_minibatches=4, feature_sizes=(32, 32))
    ppo = PPO(env, cfg)
    runner = ppo.init(jax.random.PRNGKey(0))
    runner, metrics = jax.jit(ppo.train_iteration)(runner)
    assert np.isfinite(float(metrics["loss"]))
    stats = jax.jit(ppo.evaluate, static_argnums=2)(
        runner.params, jax.random.PRNGKey(1), 8
    )
    assert np.isfinite(float(stats["mean_reward"]))


def test_packed_cached_autoreset_step():
    """cached_autoreset_step: non-done lanes match the exact step; done
    lanes take their cached reset entry (obs == cache_obs), and the cache
    refreshes on the period boundary."""
    packed = PackedQuadXModHoveringEnv.create(
        **{**KW, "max_duration_seconds": 0.1}  # 5 steps at 40 Hz
    )
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    ars, obs0 = packed.cached_autoreset_init(keys)
    # the cache is a valid reset batch, distinct from the live one
    assert not np.allclose(np.asarray(ars.cache_obs), np.asarray(obs0))

    act = jnp.zeros((N, 4))
    step = jax.jit(packed.cached_autoreset_step, static_argnums=2)
    # force half the lanes to truncate on the next step
    forced = jnp.arange(N) < N // 2
    ars = ars.replace(
        env_state=ars.env_state.replace(
            step_count=jnp.where(
                forced, packed.base.max_steps, ars.env_state.step_count
            )
        )
    )
    cache_obs_before = np.asarray(ars.cache_obs)
    exact_state, exact_out = jax.jit(packed.step)(ars.env_state, act)
    ars2, out = step(ars, act, 4)
    done = np.asarray(out.termination | out.truncation)
    assert done[: N // 2].all() and not done[N // 2 :].any()
    # done lanes: returned obs is the cached reset obs; live state matches it
    np.testing.assert_allclose(
        np.asarray(out.obs)[done], cache_obs_before[done]
    )
    # pre-reset transition surfaced (terminal_observation == exact step obs)
    np.testing.assert_allclose(
        np.asarray(out.info["terminal_observation"]),
        np.asarray(exact_out.obs), atol=1e-6,
    )
    # non-done lanes: identical to the exact (uncached) step
    np.testing.assert_allclose(
        np.asarray(out.obs)[~done], np.asarray(exact_out.obs)[~done]
    )
    np.testing.assert_array_equal(
        np.asarray(ars2.env_state.step_count)[done], 0
    )
    # refresh period 4: cache unchanged for steps 1-3, regenerated at step 4
    for i in range(3):
        ars2, _ = step(ars2, act, 4)
        if i < 2:
            np.testing.assert_array_equal(
                np.asarray(ars2.cache_obs), cache_obs_before
            )
    assert not np.allclose(np.asarray(ars2.cache_obs), cache_obs_before)


def test_ppo_native_batch_cached_reset_trains():
    """PPO + packed env + cached_reset_refresh: the round-4 headline rollout
    path compiles and trains (finite metrics)."""
    from pyflyt_tpu.rl.ppo import PPO, PPOConfig

    env = PackedQuadXModHoveringEnv.create(
        **{**KW, "max_duration_seconds": 0.5}
    )
    cfg = PPOConfig(num_envs=16, rollout_steps=8, num_epochs=2,
                    num_minibatches=4, feature_sizes=(32, 32),
                    cached_reset_refresh=4)
    ppo = PPO(env, cfg)
    runner = ppo.init(jax.random.PRNGKey(0))
    runner, metrics = jax.jit(ppo.train_iteration)(runner)
    assert np.isfinite(float(metrics["loss"]))


def test_noisy_kernel_runs_interpreted():
    """Motor noise and wind gusts on: the packed mod-hovering step runs
    interpreted, deterministic per seed and seed-sensitive."""
    from _noise import check_noisy_step

    kw = dict(KW, noisy_motors=True, max_gust_strength=7.0)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    act = jnp.tile(jnp.asarray([0.01, -0.01, 0.0, 0.1]), (N, 1))
    check_noisy_step(PackedQuadXModHoveringEnv.create(**kw), keys, act, 1.0)
