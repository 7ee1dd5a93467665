"""Packed (fused-kernel) hover env vs the reference XLA pipeline.

With noise off the fused agent step (ops/pallas_quadx.py env_fuse) must
reproduce QuadXHoverEnv exactly: obs, reward shaping, termination,
truncation, info flags, and the done-freeze semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.packed_hover import (
    PackedQuadXHoverEnv,
    packed_autoreset_init,
    packed_cached_autoreset_step,
)
from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv




N = 64


def _envs(**kw):
    base = QuadXHoverEnv(noisy_motors=False, **kw)
    return base, PackedQuadXHoverEnv(base=base)


def _actions(i, scale=0.6):
    k = jax.random.fold_in(jax.random.PRNGKey(99), i)
    a = jax.random.uniform(k, (N, 4), minval=-scale, maxval=scale)
    return a.at[:, 3].set(jnp.abs(a[:, 3]) + 0.2)


def test_reset_obs_matches():
    base, penv = _envs()
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    _, ref_obs = vec_reset(base, keys)
    _, obs = penv.reset(keys)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(ref_obs), atol=1e-6)


def test_step_trajectory_matches_xla_env():
    """8 agent steps incl. crashes/OOB: rewards, flags and freeze agree."""
    base, penv = _envs()
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    ref_st, _ = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)

    vstep = jax.vmap(base.step)
    some_done = False
    for i in range(20):
        a = _actions(i)
        # half the fleet: zero rates + zero thrust → a clean vertical fall
        # onto the ground plane (steep contact-depth crossing, so the
        # termination step is roundoff-robust between the two backends;
        # tumbling bounces are chaotic and would flip on f32 noise)
        a = a.at[: N // 2].set(0.0)
        ref_st, ref_out = vstep(ref_st, a)
        pk_st, out = penv.step(pk_st, a)
        np.testing.assert_allclose(
            np.asarray(out.obs), np.asarray(ref_out.obs), atol=2e-4,
            err_msg=f"step {i} obs",
        )
        np.testing.assert_allclose(
            np.asarray(out.reward), np.asarray(ref_out.reward), atol=2e-4,
            err_msg=f"step {i} reward",
        )
        np.testing.assert_array_equal(
            np.asarray(out.termination), np.asarray(ref_out.termination)
        )
        np.testing.assert_array_equal(
            np.asarray(out.truncation), np.asarray(ref_out.truncation)
        )
        for k in ("collision", "out_of_bounds"):
            np.testing.assert_array_equal(
                np.asarray(out.info[k]), np.asarray(ref_out.info[k]), err_msg=k
            )
        some_done |= bool(jnp.any(ref_out.termination))
    assert some_done, "test should exercise the termination/freeze path"


def test_mode7_step_trajectory_matches_xla_env():
    """The fused env in mode 7 (position-PID cascade in-kernel): obs,
    rewards, the five extra PID banks' freeze semantics and terminations
    track the XLA env."""
    # tight dome (spawn at z=1.0 -> |pos|=1.0): the escape half only needs
    # to climb 0.5 m to cross it, so the done/freeze path fires within the
    # 48-step horizon (descending to ground contact takes >1.5 s — too slow)
    base, penv = _envs(flight_mode=7, flight_dome_size=1.5)
    keys = jax.random.split(jax.random.PRNGKey(21), N)
    ref_st, _ = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    # position setpoints: half hold near spawn (|target| ~ 1.2 < dome),
    # half commanded to climb out of the dome (out_of_bounds termination)
    tgt = jnp.tile(jnp.asarray([0.1, -0.1, 0.2, 1.2]), (N, 1))
    tgt = tgt.at[: N // 2, 3].set(2.5)
    some_done = False
    for i in range(48):
        ref_st, ref_out = vstep(ref_st, tgt)
        pk_st, out = pstep(pk_st, tgt)
        # tolerance grows with the chain: the 5-bank cascade + polynomial
        # atan2 accumulate ~2e-5/step of f32 drift over 6 integrations/step
        tol = 5e-4 + 1e-4 * i
        np.testing.assert_allclose(
            np.asarray(out.obs), np.asarray(ref_out.obs), atol=tol,
            err_msg=f"step {i} obs",
        )
        np.testing.assert_allclose(
            np.asarray(out.reward), np.asarray(ref_out.reward), atol=tol,
            err_msg=f"step {i} reward",
        )
        np.testing.assert_array_equal(
            np.asarray(out.termination), np.asarray(ref_out.termination),
            err_msg=f"step {i} termination",
        )
        some_done |= bool(jnp.any(ref_out.termination))
    assert some_done, "the ground-commanded half should terminate"


def test_truncation_matches():
    base, penv = _envs(max_duration_seconds=0.1)  # max_steps = 4
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    ref_st, _ = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.vmap(base.step)
    hover = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.45]), (N, 1))
    for i in range(7):
        ref_st, ref_out = vstep(ref_st, hover)
        pk_st, out = penv.step(pk_st, hover)
        np.testing.assert_array_equal(
            np.asarray(out.truncation), np.asarray(ref_out.truncation),
            err_msg=f"step {i}",
        )
        np.testing.assert_allclose(
            np.asarray(out.reward), np.asarray(ref_out.reward), atol=2e-4
        )
    assert bool(jnp.all(out.truncation))


def test_packed_autoreset_resets_done_lanes():
    # max_steps=4 → every lane truncates at step 5, exercising the reset
    base, penv = _envs(max_duration_seconds=0.1)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    ars, _ = packed_autoreset_init(penv, keys)
    done_seen = jnp.zeros((N,), bool)
    hover = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.45]), (N, 1))
    for i in range(6):
        ars, out = packed_cached_autoreset_step(penv, ars, hover)
        done = out.termination | out.truncation
        done_seen |= done
        if bool(jnp.any(done)):
            # done lanes restart from the cached reset: step_count row is 0
            flat = ars.env_state.packed.reshape(56, -1)
            sc = flat[55]
            np.testing.assert_allclose(
                np.asarray(sc[np.asarray(done)]), 0.0
            )
    assert bool(jnp.any(done_seen))


def test_packed_env_steps_under_shard_map():
    """Multi-chip pattern for the fused env: each device owns a packed
    block; reshapes stay shard-local, so the rollout is collective-free.
    All flat (N,)-quantities (action in, obs/reward out) flow through the
    same P('env') specs, keeping the env ordering consistent end to end."""
    from jax.sharding import Mesh, PartitionSpec as P

    shard_map = jax.shard_map

    base, penv = _envs()
    ndev = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("env",))

    keys = jax.random.split(jax.random.PRNGKey(5), N)
    state, obs0 = penv.reset(keys)
    shard_keys = jax.random.split(jax.random.PRNGKey(6), ndev)

    def local_step(packed, key, act):
        st = type(state)(packed=packed, key=key[0])
        st, out = penv.step(st, act)
        return st.packed, out.obs, out.reward

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(None, None, "env"), P("env"), P("env")),
        out_specs=(P(None, None, "env"), P("env"), P("env")),
        check_vma=False,  # pallas_call out_shape carries no vma info
    )
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.45]), (N, 1))
    packed, obs, reward = jax.jit(sharded)(state.packed, shard_keys, act)
    assert packed.shape == state.packed.shape
    assert obs.shape == (N, base.obs_size)
    assert bool(jnp.all(jnp.isfinite(reward)))

    hlo = (
        jax.jit(sharded).lower(state.packed, shard_keys, act).compile().as_text()
    )
    collectives = [
        l
        for l in hlo.splitlines()
        if "all-gather" in l or "all-reduce" in l or "all-to-all" in l
        or "collective-permute" in l
    ]
    assert not collectives, collectives[:3]


def test_noisy_kernel_runs_interpreted():
    """Motor noise on: the fused hover step runs interpreted (counter-hash
    normals), deterministic per seed and seed-sensitive."""
    from _noise import check_noisy_step

    base = QuadXHoverEnv(noisy_motors=True)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    check_noisy_step(PackedQuadXHoverEnv(base=base), keys, _actions(0), 1.0)
