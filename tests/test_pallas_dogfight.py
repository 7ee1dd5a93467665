"""Fused dogfight kernel vs the XLA MAFixedwingDogfightEnv (noise off).

The packed arena step (ops/pallas_dogfight.py via envs/packed_dogfight.py)
must reproduce the vmapped reference pipeline: observations, engagement
rewards (with the one-aviary-step memo lag), hits/health, terminations,
truncations and info flags.

NOTE on agent_hz: the tests run at agent_hz=120 (1 inner aviary step = 4
unrolled drone physics iterations across the two banks). XLA:CPU compile
time of interpret-mode fused kernels is sharply superlinear in the unrolled
iteration count (see tests/test_pallas_fixedwing.py's measurements: 2 iters
23 s, 4 iters 136 s, 8 iters >20 min); the stock 30 Hz arena (16 drone
iterations) cannot compile on CPU at all. Physics/engagement math is
rate-independent — the only inner>1-specific path is the reward-memo lag
accumulation, which still round-trips through the state rows every agent
step at inner=1 — and the stock-rate kernel is compiled and parity-checked
on the GPU by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from pyflyt_tpu.envs.ma_fixedwing_dogfight import MAFixedwingDogfightEnv
from pyflyt_tpu.envs.packed_dogfight import PackedMAFixedwingDogfightEnv




N = 16


def make_envs(**kw):
    kw.setdefault("agent_hz", 120)
    base = MAFixedwingDogfightEnv(noisy_motors=False, **kw)
    penv = PackedMAFixedwingDogfightEnv(base=base)
    return base, penv


def _actions(i, n=N, dim=4, scale=0.4):
    k = jax.random.fold_in(jax.random.PRNGKey(77), i)
    a = jax.random.uniform(k, (n, 2, dim), minval=-scale, maxval=scale)
    return a.at[..., -1].set(0.75)


def _assert_step_parity(out, ref_out, i, tol):
    np.testing.assert_allclose(
        np.asarray(out.obs), np.asarray(ref_out.obs), atol=tol,
        err_msg=f"step {i} obs",
    )
    np.testing.assert_allclose(
        np.asarray(out.reward), np.asarray(ref_out.reward),
        atol=tol, rtol=1e-4, err_msg=f"step {i} reward",
    )
    np.testing.assert_array_equal(
        np.asarray(out.termination), np.asarray(ref_out.termination),
        err_msg=f"step {i} termination",
    )
    np.testing.assert_array_equal(
        np.asarray(out.truncation), np.asarray(ref_out.truncation),
        err_msg=f"step {i} truncation",
    )
    for k in ("collision", "out_of_bounds", "wins"):
        np.testing.assert_array_equal(
            np.asarray(out.info[k]), np.asarray(ref_out.info[k]),
            err_msg=f"step {i} info[{k}]",
        )
    np.testing.assert_allclose(
        np.asarray(out.info["healths"]),
        np.asarray(ref_out.info["healths"]),
        atol=1e-5, err_msg=f"step {i} healths",
    )


def test_reset_trajectory_and_dead_agent_match():
    """Reset obs, 12 agent steps of engagement-heavy random actions, then the
    dead-agent masking/other_dead-termination path — all against the vmapped
    XLA env, sharing one compile of each step function."""
    base, penv = make_envs()
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    ref_st, ref_obs = jax.jit(jax.vmap(base.reset))(keys)
    pk_st, obs = penv.reset(keys)
    # 1e-4: jit-vs-eager fusion differences in the shared XLA reset math
    np.testing.assert_allclose(np.asarray(obs), np.asarray(ref_obs), atol=1e-4)

    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    for i in range(12):
        a = _actions(i)
        ref_st, ref_out = vstep(ref_st, a)
        pk_st, out = pstep(pk_st, a)
        _assert_step_parity(out, ref_out, i, tol=2e-3 + 1e-3 * i)

    # force agent 1 dead in both representations: its actions must zero and
    # the arena must terminate on the next step (other_dead)
    dead = jnp.ones((N, 2), bool).at[:, 1].set(False)
    ref_st = ref_st.replace(alive=dead)
    pk_st = pk_st.replace(alive=dead)
    a = _actions(99)
    ref_st, ref_out = vstep(ref_st, a)
    pk_st, out = pstep(pk_st, a)
    np.testing.assert_array_equal(
        np.asarray(out.termination), np.asarray(ref_out.termination)
    )
    assert bool(jnp.all(out.termination)), "other_dead must terminate"
    np.testing.assert_array_equal(
        np.asarray(out.agents_mask), np.asarray(ref_out.agents_mask)
    )


def test_oob_termination_matches():
    """A tiny flight dome forces out-of-bounds on the first step: the -3000
    penalty, info flags and termination must match the XLA env."""
    base, penv = make_envs(flight_dome_size=10.0)  # spawn_height 15 > dome
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    ref_st, _ = jax.jit(jax.vmap(base.reset))(keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    some_done = False
    for i in range(2):
        a = _actions(i)
        ref_st, ref_out = vstep(ref_st, a)
        pk_st, out = pstep(pk_st, a)
        _assert_step_parity(out, ref_out, i, tol=2e-3)
        some_done |= bool(jnp.any(ref_out.termination))
    assert some_done, "a 10 m dome with 15 m spawns must go out-of-bounds"


def test_unassisted_mode_matches():
    """assisted_flight=False: the 6-dim raw surface passthrough through the
    mode-0 assist map (the reference's set_mode(0) quirk)."""
    base, penv = make_envs(assisted_flight=False)
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    ref_st, _ = jax.jit(jax.vmap(base.reset))(keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    for i in range(4):
        a = _actions(i, dim=6, scale=0.3)
        ref_st, ref_out = vstep(ref_st, a)
        pk_st, out = pstep(pk_st, a)
        np.testing.assert_allclose(
            np.asarray(out.obs), np.asarray(ref_out.obs), atol=2e-3,
            err_msg=f"step {i} obs",
        )
        np.testing.assert_allclose(
            np.asarray(out.reward), np.asarray(ref_out.reward), atol=2e-3,
            rtol=1e-4, err_msg=f"step {i} reward",
        )


def test_packed_env_steps_under_shard_map():
    """Multi-chip pattern: each device owns a lane-block of ARENAS; the
    fused dogfight rollout lowers with zero collectives (the alive/action
    bookkeeping is per-arena, so sharding the arena axis is clean)."""
    from jax.sharding import Mesh, PartitionSpec as P

    base, penv = make_envs()
    mesh = Mesh(np.array(jax.devices()), ("env",))

    n = 8 * len(jax.devices())  # one packed lane-block of arenas per device
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    state, _ = penv.reset(keys)
    shard_keys = jax.random.split(jax.random.PRNGKey(6), len(jax.devices()))

    def local_step(packed, key, alive, cur, past, act):
        st = type(state)(
            packed=packed, key=key[0], alive=alive,
            current_actions=cur, past_actions=past,
        )
        st, out = penv.step(st, act)
        return st.packed, out.obs, out.reward

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(None, None, "env"), P("env"), P("env"), P("env"), P("env"),
            P("env"),
        ),
        out_specs=(P(None, None, "env"), P("env"), P("env")),
        check_vma=False,
    )
    act = _actions(0, n=n)
    packed, obs, reward = jax.jit(sharded)(
        state.packed, shard_keys, state.alive, state.current_actions,
        state.past_actions, act,
    )
    assert packed.shape == state.packed.shape
    assert bool(jnp.all(jnp.isfinite(reward)))

    hlo = (
        jax.jit(sharded)
        .lower(
            state.packed, shard_keys, state.alive, state.current_actions,
            state.past_actions, act,
        )
        .compile()
        .as_text()
    )
    collectives = [
        l
        for l in hlo.splitlines()
        if "all-gather" in l or "all-reduce" in l or "all-to-all" in l
        or "collective-permute" in l
    ]
    assert not collectives, collectives[:3]


def test_noisy_kernel_runs_interpreted():
    """Motor noise on: the fused dogfight step runs interpreted,
    deterministic per seed and seed-sensitive."""
    from _noise import check_noisy_step

    base = MAFixedwingDogfightEnv(noisy_motors=True, agent_hz=120)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    check_noisy_step(
        PackedMAFixedwingDogfightEnv(base=base), keys, _actions(0), 50.0
    )
