"""Pallas Fixedwing kernel correctness vs the XLA path (interpret mode, CPU).

The kernel (ops/pallas_fixedwing.py) must reproduce models/fixedwing.py
(noise off) to float32 roundoff, and the fused waypoints agent step
(envs/packed_fixedwing_waypoints.py) must reproduce FixedwingWaypointsEnv:
obs, reward shaping, waypoint advancement, termination, truncation, and the
done-freeze semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from pyflyt_tpu.envs.base import vec_reset
from pyflyt_tpu.envs.fixedwing_waypoints import FixedwingWaypointsEnv
from pyflyt_tpu.envs.packed_fixedwing_waypoints import (
    PackedFixedwingWaypointsEnv,
)
from pyflyt_tpu.models import fixedwing
from pyflyt_tpu.ops import pallas_fixedwing




def _random_state(cfg, params, mode, n=64, seed=0, alt=50.0):
    key = jax.random.PRNGKey(seed)
    pos = jax.random.uniform(key, (n, 3), minval=-5, maxval=5) + jnp.asarray(
        [0.0, 0.0, alt]
    )
    orn = jax.random.uniform(
        jax.random.fold_in(key, 1), (n, 3), minval=-0.5, maxval=0.5
    )
    st = fixedwing.init_state(params, cfg, pos, orn, mode)
    # varied speeds: cruise, slow (post-stall AoA), climbing
    vel = jnp.asarray([15.0, 0.0, 0.0]) + 6.0 * jax.random.normal(
        jax.random.fold_in(key, 3), (n, 3)
    )
    st = st.replace(
        body=st.body.replace(
            lin_vel=vel,
            ang_vel=0.6 * jax.random.normal(jax.random.fold_in(key, 4), (n, 3)),
        ),
        actuation=0.4
        * jax.random.normal(jax.random.fold_in(key, 5), (n, 5)),
        throttle=jnp.abs(
            0.5 * jax.random.normal(jax.random.fold_in(key, 6), (n, 1))
        ),
    )
    return st.replace(
        read=fixedwing.update_state(
            st.body, params, cfg, st.physics_steps
        )
    )


def _assert_state_close(out, ref, atol_pos=3e-5, prefix=""):
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=atol_pos,
        err_msg=f"{prefix}pos",
    )
    np.testing.assert_allclose(
        np.asarray(out.body.quat), np.asarray(ref.body.quat), atol=1e-5,
        err_msg=f"{prefix}quat",
    )
    np.testing.assert_allclose(
        np.asarray(out.body.lin_vel), np.asarray(ref.body.lin_vel), atol=1e-3,
        err_msg=f"{prefix}lin_vel",
    )
    np.testing.assert_allclose(
        np.asarray(out.body.ang_vel), np.asarray(ref.body.ang_vel), atol=2e-3,
        err_msg=f"{prefix}ang_vel",
    )
    np.testing.assert_allclose(
        np.asarray(out.read.view), np.asarray(ref.read.view), atol=1e-3,
        err_msg=f"{prefix}view",
    )
    np.testing.assert_allclose(
        np.asarray(out.read.surface_local_vel),
        np.asarray(ref.read.surface_local_vel),
        atol=1e-3,
        err_msg=f"{prefix}surface_local_vel",
    )
    np.testing.assert_allclose(
        np.asarray(out.actuation), np.asarray(ref.actuation), atol=1e-5,
        err_msg=f"{prefix}actuation",
    )
    np.testing.assert_allclose(
        np.asarray(out.throttle), np.asarray(ref.throttle), atol=1e-5,
        err_msg=f"{prefix}throttle",
    )


@pytest.mark.parametrize("mode", [0, -1])
def test_kernel_matches_xla(mode):
    cfg = fixedwing.FixedwingConfig(noisy_motors=False)
    params = fixedwing.build_params(cfg)
    st = _random_state(cfg, params, mode)
    n = st.body.pos.shape[0]
    sp_dim = 6 if mode == -1 else 4
    sp = jax.random.uniform(
        jax.random.PRNGKey(7), (n, sp_dim), minval=-0.6, maxval=0.6
    )
    sp = sp.at[:, -1].set(jnp.abs(sp[:, -1]))  # thrust >= 0
    st = st.replace(setpoint=sp)

    ref, ref_contact = fixedwing.step(st, params, cfg, mode)
    out, contact = pallas_fixedwing.step(st, params, cfg, mode)

    _assert_state_close(out, ref)
    np.testing.assert_array_equal(
        np.asarray(contact), np.asarray(ref_contact)
    )


def test_kernel_trajectory_matches():
    """30 consecutive aviary steps (no ground contact) stay locked."""
    cfg = fixedwing.FixedwingConfig(noisy_motors=False)
    params = fixedwing.build_params(cfg)
    st = _random_state(cfg, params, 0, n=32, seed=11, alt=200.0)
    ref = st
    sp = jnp.tile(jnp.asarray([0.05, -0.05, 0.0, 0.6]), (32, 1))
    st = st.replace(setpoint=sp)
    ref = ref.replace(setpoint=sp)
    ref_step = jax.jit(lambda s: fixedwing.step(s, params, cfg, 0)[0])
    pk_step = jax.jit(lambda s: pallas_fixedwing.step(s, params, cfg, 0)[0])
    for i in range(30):
        ref = ref_step(ref)
        st = pk_step(st)
    _assert_state_close(st, ref, atol_pos=2e-3, prefix="t30 ")


# ---------------------------------------------------------------------------
# fused waypoints env
# ---------------------------------------------------------------------------

N = 64

# NOTE on agent_hz: XLA:CPU compile time of the fused kernel is sharply
# superlinear in the unrolled physics-iteration count (agent_hz 120 → 2
# iters → 23 s; 60 → 4 iters → 136 s; the stock 30 → 8 iters → >20 min), so
# the parity tests run at raised agent rates: the trajectory test at 60 Hz
# still exercises the mid-agent-step freeze (2 inner aviary steps), the rest
# at 120 Hz. Physics/task math is rate-independent; the stock 30 Hz config
# is compiled and checked on the GPU by chip_smoke.py.


def _envs(**kw):
    base = FixedwingWaypointsEnv(noisy_motors=False, **kw)
    return base, PackedFixedwingWaypointsEnv(base=base)


def _actions(i, scale=0.4):
    k = jax.random.fold_in(jax.random.PRNGKey(99), i)
    a = jax.random.uniform(k, (N, 4), minval=-scale, maxval=scale)
    return a.at[:, 3].set(jnp.abs(a[:, 3]) + 0.3)


def _assert_out_close(out, ref_out, i):
    np.testing.assert_allclose(
        np.asarray(out.obs["attitude"]),
        np.asarray(ref_out.obs["attitude"]),
        atol=5e-4,
        err_msg=f"step {i} attitude",
    )
    np.testing.assert_allclose(
        np.asarray(out.obs["target_deltas"]),
        np.asarray(ref_out.obs["target_deltas"]),
        atol=5e-3,
        err_msg=f"step {i} target_deltas",
    )
    np.testing.assert_allclose(
        np.asarray(out.reward), np.asarray(ref_out.reward), atol=5e-3,
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
    for k in ("collision", "out_of_bounds", "env_complete"):
        np.testing.assert_array_equal(
            np.asarray(out.info[k]), np.asarray(ref_out.info[k]),
            err_msg=f"step {i} {k}",
        )
    np.testing.assert_array_equal(
        np.asarray(out.info["num_targets_reached"]),
        np.asarray(ref_out.info["num_targets_reached"]),
        err_msg=f"step {i} num_targets_reached",
    )


def test_reset_obs_matches():
    base, penv = _envs()
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    _, ref_obs = vec_reset(base, keys)
    _, obs = penv.reset(keys)
    np.testing.assert_allclose(
        np.asarray(obs["attitude"]), np.asarray(ref_obs["attitude"]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(obs["target_deltas"]),
        np.asarray(ref_obs["target_deltas"]),
        atol=1e-6,
    )


def test_step_trajectory_matches_xla_env():
    """20 agent steps with a large reach radius: target advancement, +100
    rewards, OOB/crash terminations and the freeze agree with the XLA env."""
    base, penv = _envs(goal_reach_distance=25.0, agent_hz=60)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    ref_st, _ = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)

    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    reached = False
    some_done = False
    for i in range(20):
        a = _actions(i)
        ref_st, ref_out = vstep(ref_st, a)
        pk_st, out = pstep(pk_st, a)
        _assert_out_close(out, ref_out, i)
        reached |= bool(jnp.any(out.info["num_targets_reached"] > 0))
        some_done |= bool(jnp.any(ref_out.termination | ref_out.truncation))
    assert reached, "test should exercise target advancement"
    assert some_done, "test should exercise the termination/freeze path"


def test_truncation_and_completion_match():
    """Tiny horizon + huge reach radius: every env truncates either by
    completing all targets or by step count, identically on both paths."""
    base, penv = _envs(
        goal_reach_distance=120.0, max_duration_seconds=0.05, agent_hz=120
    )
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    ref_st, _ = vec_reset(base, keys)
    pk_st, _ = penv.reset(keys)
    vstep = jax.jit(jax.vmap(base.step))
    pstep = jax.jit(penv.step)
    cruise = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.5]), (N, 1))
    for i in range(9):
        ref_st, ref_out = vstep(ref_st, cruise)
        pk_st, out = pstep(pk_st, cruise)
        _assert_out_close(out, ref_out, i)
    assert bool(jnp.all(out.truncation | out.termination))
    assert bool(jnp.any(out.info["env_complete"]))


def test_packed_env_steps_under_shard_map():
    """Multi-chip pattern: each device owns a packed lane-block; the fused
    waypoints rollout lowers with zero collectives."""
    from jax.sharding import Mesh, PartitionSpec as P

    base, penv = _envs(agent_hz=120)
    ndev = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("env",))

    keys = jax.random.split(jax.random.PRNGKey(5), N)
    state, _ = penv.reset(keys)
    shard_keys = jax.random.split(jax.random.PRNGKey(6), ndev)

    def local_step(packed, key, act):
        st = type(state)(packed=packed, key=key[0])
        st, out = penv.step(st, act)
        return st.packed, out.obs["attitude"], out.reward

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(None, None, "env"), P("env"), P("env")),
        out_specs=(P(None, None, "env"), P("env"), P("env")),
        check_vma=False,
    )
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.5]), (N, 1))
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
    """Motor noise on: the fused fixedwing waypoints step runs interpreted,
    deterministic per seed and seed-sensitive (120 Hz agent rate, see the
    note above on compile time)."""
    from _noise import check_noisy_step

    base = FixedwingWaypointsEnv(noisy_motors=True, agent_hz=120)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    check_noisy_step(
        PackedFixedwingWaypointsEnv(base=base), keys, _actions(0), 1.0
    )
