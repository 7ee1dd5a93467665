"""Fused rocket kernel vs the XLA model/env (noise off).

Covers the rocket-specific machinery none of the other kernels have: the
fuel-tracked composite mass/CoM/inertia, gimballed booster, register
lever-arm finlets, and the pad-aware IMPULSE contact model (the landing task
observes post-contact dynamics, so resting/settling must match, not just
detection).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.packed_rocket_landing import PackedRocketLandingEnv
from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv
from pyflyt_tpu.models import rocket
from pyflyt_tpu.ops import pallas_rocket




N = 16


def _cfg():
    return rocket.RocketConfig(noisy_boosters=False, starting_fuel_ratio=0.30)


def _batched_state(cfg, params, n=N, seed=0, alt=30.0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    pos = jax.random.uniform(k1, (n, 3), minval=-2.0, maxval=2.0)
    pos = pos.at[:, 2].set(alt)
    orn = jax.random.uniform(k2, (n, 3), minval=-0.3, maxval=0.3)
    vel = jax.random.uniform(k3, (n, 3), minval=-3.0, maxval=3.0)
    return rocket.init_state(params, cfg, pos, orn, vel)


def _active_setpoint(n=N):
    # finlets deflected, booster lit at 60% throttle, gimbal swung
    sp = jnp.tile(
        jnp.asarray([0.3, -0.2, 0.1, 1.0, 0.6, 0.25, -0.15]), (n, 1)
    )
    return sp


def test_pack_unpack_roundtrip():
    cfg = _cfg()
    params = rocket.build_params(cfg)
    st = _batched_state(cfg, params)
    st = st.replace(setpoint=_active_setpoint())
    packed = pallas_rocket.pack_state(st)
    assert packed.shape == (pallas_rocket.ROWS, 8, N // 8)
    st2 = pallas_rocket.unpack_state(packed, st)
    for a, b in zip(jax.tree.leaves(st2), jax.tree.leaves(st)):
        if a.dtype == jnp.float32 or a.dtype == bool:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_matches_xla_step():
    """One aviary step (burn + gimbal + finlets + drag + composite-inertia
    integration): full state parity vs the batched XLA rocket.step."""
    cfg = _cfg()
    params = rocket.build_params(cfg)
    st = _batched_state(cfg, params)
    st = rocket.update_control(
        st.replace(setpoint=_active_setpoint()), params, cfg
    )

    ref, ref_g, ref_p = rocket.step(st, params, cfg, None)

    packed = pallas_rocket.pack_state(st)
    out = jax.jit(
        lambda p: pallas_rocket.packed_step(
            p, jnp.zeros((), jnp.int32), params, cfg, noisy=False
        )
    )(packed)
    got = pallas_rocket.unpack_state(out, st)

    np.testing.assert_allclose(
        np.asarray(got.body.pos), np.asarray(ref.body.pos), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.body.quat), np.asarray(ref.body.quat), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.body.lin_vel), np.asarray(ref.body.lin_vel), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.body.ang_vel), np.asarray(ref.body.ang_vel), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.read.view), np.asarray(ref.read.view), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.read.finlet_local_vel),
        np.asarray(ref.read.finlet_local_vel), atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(got.booster.ratio_fuel_remaining),
        np.asarray(ref.booster.ratio_fuel_remaining), atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(got.booster.throttle),
        np.asarray(ref.booster.throttle), atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(got.booster.ignition_state),
        np.asarray(ref.booster.ignition_state),
    )
    np.testing.assert_allclose(
        np.asarray(got.gimbal_state), np.asarray(ref.gimbal_state), atol=1e-6
    )


def test_kernel_burn_trajectory():
    """12 chained aviary steps under a full burn: fuel depletion, shifting
    CoM/inertia and the gimballed thrust keep tracking the XLA path."""
    cfg = _cfg()
    params = rocket.build_params(cfg)
    st = _batched_state(cfg, params, seed=3, alt=80.0)
    st = st.replace(setpoint=_active_setpoint())

    ref = out_st = st
    packed = pallas_rocket.pack_state(st)
    pstep = jax.jit(
        lambda p: pallas_rocket.packed_step(
            p, jnp.zeros((), jnp.int32), params, cfg, noisy=False
        )
    )
    for i in range(12):
        ref = rocket.update_control(ref, params, cfg)
        ref, _, _ = rocket.step(ref, params, cfg, None)
        packed = pstep(packed)
        got = pallas_rocket.unpack_state(packed, st)
        tol = 3e-3 + 1e-3 * i
        np.testing.assert_allclose(
            np.asarray(got.body.pos), np.asarray(ref.body.pos), atol=tol,
            err_msg=f"step {i} pos",
        )
        np.testing.assert_allclose(
            np.asarray(got.body.ang_vel), np.asarray(ref.body.ang_vel),
            atol=tol, err_msg=f"step {i} ang_vel",
        )
        np.testing.assert_allclose(
            np.asarray(got.booster.ratio_fuel_remaining),
            np.asarray(ref.booster.ratio_fuel_remaining), atol=1e-5,
            err_msg=f"step {i} fuel",
        )


def _low_env(**kw):
    return RocketLandingEnv(
        ceiling=30.0,
        max_displacement=20.0,
        start_pos=((0.0, 0.0, 8.0),),
        randomize_drop=False,  # keep the 8 m drop: ground inside 60 steps
        accelerate_drop=False,
        starting_fuel_ratio=0.30,
        noisy_boosters=False,
        **kw,
    )


def test_env_trajectory_matches_xla():
    """Low-altitude drop through the fused env: shaped rewards, pad flags,
    ground termination and the done-freeze track the XLA env."""
    base = _low_env()
    penv = PackedRocketLandingEnv(base=base)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    ref_st, ref_obs = vec_reset(base, keys)
    pk_st, obs = penv.reset(keys)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(ref_obs), atol=1e-5)

    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    # idle thrust: the rocket falls from ~25 m (randomized drop) onto the
    # ground (or pad) within ~2.5 s = 100 agent steps; check the first 60
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]), (N, 1))
    some_done = False
    for i in range(60):
        ref_st, ref_out = vstep(ref_st, act)
        pk_st, out = pstep(pk_st, act)
        tol = 1e-3 + 2e-4 * i
        np.testing.assert_allclose(
            np.asarray(out.obs), np.asarray(ref_out.obs), atol=5e-3 + 1e-3 * i,
            err_msg=f"step {i} obs",
        )
        np.testing.assert_allclose(
            np.asarray(out.reward), np.asarray(ref_out.reward),
            atol=tol, rtol=1e-3, err_msg=f"step {i} reward",
        )
        np.testing.assert_array_equal(
            np.asarray(out.termination), np.asarray(ref_out.termination),
            err_msg=f"step {i} termination",
        )
        np.testing.assert_array_equal(
            np.asarray(out.truncation), np.asarray(ref_out.truncation),
            err_msg=f"step {i} truncation",
        )
        for k in ("fatal_collision", "out_of_bounds", "env_complete"):
            np.testing.assert_array_equal(
                np.asarray(out.info[k]), np.asarray(ref_out.info[k]),
                err_msg=f"step {i} info[{k}]",
            )
        some_done |= bool(jnp.any(ref_out.termination))
    assert some_done, "free-falling rockets should hit the ground in 60 steps"


def test_resting_contact_matches():
    """Impulse-contact parity where it is observable: a rocket dropped just
    above the ground settles (not detection-only — velocities, impulses and
    positional projection must track the XLA integrator)."""
    cfg = _cfg()
    params = rocket.build_params(cfg)
    n = 8
    pos = jnp.tile(jnp.asarray([0.0, 0.0, 2.6]), (n, 1))
    orn = jnp.zeros((n, 3))
    st = rocket.init_state(params, cfg, pos, orn)
    st = st.replace(setpoint=jnp.zeros((n, 7)))

    ref = st
    packed = pallas_rocket.pack_state(st)
    pstep = jax.jit(
        lambda p: pallas_rocket.packed_step(
            p, jnp.zeros((), jnp.int32), params, cfg, noisy=False
        )
    )
    touched = False
    for i in range(30):
        ref = rocket.update_control(ref, params, cfg)
        ref, ref_g, _ = rocket.step(ref, params, cfg, None)
        packed = pstep(packed)
        got = pallas_rocket.unpack_state(packed, st)
        np.testing.assert_allclose(
            np.asarray(got.body.pos), np.asarray(ref.body.pos),
            atol=2e-3, err_msg=f"step {i} pos",
        )
        np.testing.assert_allclose(
            np.asarray(got.body.lin_vel), np.asarray(ref.body.lin_vel),
            atol=5e-3, err_msg=f"step {i} lin_vel",
        )
        np.testing.assert_allclose(
            np.asarray(got.body.ang_vel), np.asarray(ref.body.ang_vel),
            atol=5e-3, err_msg=f"step {i} ang_vel",
        )
        touched |= bool(jnp.any(ref_g))
    assert touched, "the rocket must reach the ground in this scenario"


def test_packed_env_steps_under_shard_map():
    """Multi-chip pattern: each device owns a packed lane-block; the fused
    rocket-landing rollout lowers with zero collectives."""
    from jax.sharding import Mesh, PartitionSpec as P

    base = _low_env()
    penv = PackedRocketLandingEnv(base=base)
    mesh = Mesh(np.array(jax.devices()), ("env",))

    n = 8 * len(jax.devices())  # one packed lane-block per device
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    state, _ = penv.reset(keys)
    shard_keys = jax.random.split(jax.random.PRNGKey(6), len(jax.devices()))

    def local_step(packed, key, act):
        st = type(state)(packed=packed, key=key[0])
        st, out = penv.step(st, act)
        return st.packed, out.obs, out.reward

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(None, None, "env"), P("env"), P("env")),
        out_specs=(P(None, None, "env"), P("env"), P("env")),
        check_vma=False,
    )
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0]), (n, 1))
    packed, obs, reward = jax.jit(sharded)(state.packed, shard_keys, act)
    assert packed.shape == state.packed.shape
    assert bool(jnp.all(jnp.isfinite(reward)))

    hlo = (
        jax.jit(sharded)
        .lower(state.packed, shard_keys, act)
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
    """Booster noise on: the fused landing step runs interpreted,
    deterministic per seed and seed-sensitive."""
    from _noise import check_noisy_step

    import dataclasses

    base = dataclasses.replace(_low_env(), noisy_boosters=True)
    n = 16
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0]), (n, 1))
    check_noisy_step(PackedRocketLandingEnv(base=base), keys, act, 1.0)
