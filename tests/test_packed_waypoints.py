"""Packed (fused-kernel) QuadX Waypoints env vs the reference XLA pipeline.

With noise off the fused agent step (ops/pallas_quadx.py env_fuse with the
``waypoints`` extension) must reproduce QuadXWaypointsEnv exactly: dict obs
(attitude + rolled/masked target deltas), progress/proximity reward shaping,
the 100-point target-reach overwrite, cyclic target advancement,
all-targets-reached truncation, termination and the done-freeze.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.packed_quadx_waypoints import PackedQuadXWaypointsEnv
from pyflyt_tpu.envs.quadx_waypoints import QuadXWaypointsEnv




N = 64


def _envs(**kw):
    kw.setdefault("flight_mode", 7)
    base = QuadXWaypointsEnv(noisy_motors=False, **kw)
    return base, PackedQuadXWaypointsEnv(base=base)


def _assert_obs(out_obs, ref_obs, i, tol):
    np.testing.assert_allclose(
        np.asarray(out_obs["attitude"]), np.asarray(ref_obs["attitude"]),
        atol=tol, err_msg=f"step {i} attitude",
    )
    np.testing.assert_allclose(
        np.asarray(out_obs["target_deltas"]),
        np.asarray(ref_obs["target_deltas"]),
        atol=tol, err_msg=f"step {i} target_deltas",
    )


def test_reset_obs_matches():
    base, penv = _envs()
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    _, ref_obs = vec_reset(base, keys)
    _, obs = penv.reset(keys)
    _assert_obs(obs, ref_obs, -1, 1e-6)


def test_mode7_reach_trajectory_matches_xla_env():
    """Mode 7 commanded at the first waypoint: the fleet flies to it, banks
    the 100-point reach rewards, targets advance (cyclic roll vs cursor) and
    deltas/rewards keep matching afterwards. goal_reach_distance=0.6 keeps
    the reach events inside the low-f32-drift horizon (the stock 0.2 needs
    >32 steps of chase, where chaotic lane divergence dominates — see the
    measured control below)."""
    base, penv = _envs(goal_reach_distance=0.6)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    ref_st, ref_obs = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)

    reach_total = 0
    for i in range(32):
        # chase the CURRENT target: world position = body deltas rotated
        # back... simpler: command the known world target of the XLA state
        cur = jnp.take_along_axis(
            ref_st.wp.targets, ref_st.wp.idx[:, None, None], axis=1
        )[:, 0]
        act = jnp.concatenate(
            [cur[:, :2], jnp.zeros((N, 1)), cur[:, 2:]], axis=-1
        )
        ref_st, ref_out = vstep(ref_st, act)
        pk_st, out = pstep(pk_st, act)
        # f32 drift over the chained 5-bank cascade + active long-range
        # flight: ~4e-4/step for the bulk; individual lanes near chaotic
        # attitude transients diverge much faster. MEASURED CONTROL: the
        # XLA env against ITSELF (jit vs eager, identical math) drifts one
        # lane past this same tolerance curve by step 20 and reaches 1e-1
        # max by step 39 — so the comparison is lane-level: at most 4 of
        # the 64 envs may exceed the tolerance at any step.
        tol = 5e-4 + 4e-4 * i
        bad = np.zeros((N,), bool)
        for part in ("attitude", "target_deltas"):
            d = np.abs(
                np.asarray(out.obs[part]) - np.asarray(ref_out.obs[part])
            )
            bad |= d.reshape(N, -1).max(axis=-1) > tol
        dr = np.abs(np.asarray(out.reward) - np.asarray(ref_out.reward))
        bad |= dr > tol
        assert int(bad.sum()) <= 4, (
            f"step {i}: {int(bad.sum())} lanes diverged beyond {tol:.2e}"
        )
        np.testing.assert_array_equal(
            np.asarray(out.termination), np.asarray(ref_out.termination),
            err_msg=f"step {i} termination",
        )
        np.testing.assert_array_equal(
            np.asarray(out.truncation), np.asarray(ref_out.truncation),
            err_msg=f"step {i} truncation",
        )
        np.testing.assert_array_equal(
            np.asarray(out.info["num_targets_reached"]),
            np.asarray(ref_st.wp.idx),
            err_msg=f"step {i} num_targets_reached",
        )
        for k in ("collision", "out_of_bounds", "env_complete"):
            np.testing.assert_array_equal(
                np.asarray(out.info[k]), np.asarray(ref_out.info[k]),
                err_msg=f"step {i} info[{k}]",
            )
        reach_total += int(jnp.sum(ref_out.reward >= 99.0))
    assert reach_total > 0, "the chase should reach waypoints in 40 steps"


def test_mode0_crash_and_truncation_match():
    """Mode 0 (ang-vel setpoints) random flight: crashes/OOB terminate, the
    4-step truncation fires, and the frozen lanes stay frozen."""
    base, penv = _envs(flight_mode=0, max_duration_seconds=0.3)  # 9 steps
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    ref_st, _ = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    some_done = False
    for i in range(12):
        k = jax.random.fold_in(jax.random.PRNGKey(5), i)
        act = jax.random.uniform(k, (N, 4), minval=-0.6, maxval=0.6)
        act = act.at[:, 3].set(jnp.abs(act[:, 3]) * 0.3)  # weak thrust: fall
        ref_st, ref_out = vstep(ref_st, act)
        pk_st, out = pstep(pk_st, act)
        tol = 5e-4 + 2e-4 * i
        _assert_obs(out.obs, ref_out.obs, i, tol)
        np.testing.assert_allclose(
            np.asarray(out.reward), np.asarray(ref_out.reward), atol=tol,
            err_msg=f"step {i} reward",
        )
        np.testing.assert_array_equal(
            np.asarray(out.termination), np.asarray(ref_out.termination),
            err_msg=f"step {i} termination",
        )
        np.testing.assert_array_equal(
            np.asarray(out.truncation), np.asarray(ref_out.truncation),
            err_msg=f"step {i} truncation",
        )
        some_done |= bool(jnp.any(ref_out.termination | ref_out.truncation))
    assert some_done


def test_noisy_kernel_runs_interpreted():
    """Motor noise on: the fused waypoints step runs interpreted,
    deterministic per seed and seed-sensitive."""
    from _noise import check_noisy_step

    base = QuadXWaypointsEnv(noisy_motors=True, flight_mode=7)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    act = jnp.tile(jnp.asarray([0.5, 0.5, 0.0, 1.0]), (N, 1))
    check_noisy_step(PackedQuadXWaypointsEnv(base=base), keys, act, 1.0)
