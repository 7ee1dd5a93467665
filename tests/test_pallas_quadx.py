"""Pallas QuadX kernel correctness vs the XLA path (interpret mode on CPU).

The kernel (ops/pallas_quadx.py) must reproduce models/quadx.py exactly
(noise off) — positions/velocities/quaternions/PID state to float32 roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


from pyflyt_tpu.models import quadx
from pyflyt_tpu.ops import pallas_quadx




def _random_state(cfg, params, n=256, seed=0):
    key = jax.random.PRNGKey(seed)
    pos = jax.random.uniform(key, (n, 3), minval=-2, maxval=2) + jnp.asarray(
        [0.0, 0.0, 5.0]
    )
    orn = jax.random.uniform(
        jax.random.fold_in(key, 1), (n, 3), minval=-0.4, maxval=0.4
    )
    st = quadx.init_state(params, cfg, pos, orn)
    st = quadx.set_mode(st, 0, cfg)
    st = st.replace(
        body=st.body.replace(
            lin_vel=jax.random.normal(jax.random.fold_in(key, 3), (n, 3)),
            ang_vel=0.5 * jax.random.normal(jax.random.fold_in(key, 4), (n, 3)),
        )
    )
    return st.replace(read=quadx.update_state(st.body, cfg))


@pytest.mark.parametrize("mode", [0, 7, 8])
def test_kernel_matches_xla(mode):
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params)
    if mode == 7:
        st = quadx.set_mode(st, 7, cfg)
        # position setpoints [x, y, yaw, z] around the spawn region
        sp = jax.random.uniform(
            jax.random.PRNGKey(7), (256, 4), minval=-2.0, maxval=2.0
        ).at[:, 3].set(5.0)
    else:
        sp = jax.random.uniform(
            jax.random.PRNGKey(7), (256, 4), minval=-0.3, maxval=0.3
        ).at[:, 3].set(0.4)
        if mode == 8:
            sp = jnp.abs(sp)
    st = st.replace(setpoint=sp)

    ref, ref_contact = quadx.step(st, params, cfg, mode)
    out, contact = pallas_quadx.step(st, params, cfg, mode)

    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.body.quat), np.asarray(ref.body.quat), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.body.lin_vel), np.asarray(ref.body.lin_vel), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.body.ang_vel), np.asarray(ref.body.ang_vel), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.read.view), np.asarray(ref.read.view), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.throttle), np.asarray(ref.throttle), atol=2e-6
    )
    np.testing.assert_array_equal(np.asarray(contact), np.asarray(ref_contact))


def test_kernel_multi_step_trajectory():
    """20 chained kernel steps stay glued to the XLA trajectory."""
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params, n=128, seed=3)
    st = st.replace(
        setpoint=jnp.tile(jnp.asarray([0.1, -0.1, 0.2, 0.42]), (128, 1))
    )
    ref = out = st
    for _ in range(20):
        ref, _ = quadx.step(ref, params, cfg, 0)
        out, _ = pallas_quadx.step(out, params, cfg, 0)
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.body.quat), np.asarray(ref.body.quat), atol=5e-4
    )


def test_kernel_mode7_trajectory_and_pid_state():
    """15 chained mode-7 steps: the full position cascade's five PID banks
    accumulate identically to the XLA path (integral + prev_error compared
    bank by bank)."""
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params, n=128, seed=7)
    st = quadx.set_mode(st, 7, cfg)
    st = st.replace(
        setpoint=jnp.tile(jnp.asarray([1.0, -1.0, 0.5, 6.0]), (128, 1))
    )
    ref = out = st
    for _ in range(15):
        ref, _ = quadx.step(ref, params, cfg, 7)
        out, _ = pallas_quadx.step(out, params, cfg, 7)
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.body.quat), np.asarray(ref.body.quat), atol=5e-4
    )
    for bank in ("ang_vel", "ang_pos", "lin_vel", "lin_pos", "z_pos", "z_vel"):
        o = getattr(out.pids, bank)
        r = getattr(ref.pids, bank)
        np.testing.assert_allclose(
            np.asarray(o.integral), np.asarray(r.integral), atol=1e-4,
            err_msg=f"{bank} integral",
        )
        np.testing.assert_allclose(
            np.asarray(o.prev_error), np.asarray(r.prev_error), atol=4e-3,
            err_msg=f"{bank} prev_error",
        )


def test_mode7_pack_unpack_roundtrip():
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params, n=128, seed=9)
    st = quadx.set_mode(st, 7, cfg)
    # non-trivial PID state in every bank
    k = jax.random.PRNGKey(11)
    pids = st.pids
    for i, bank in enumerate(
        ("ang_vel", "ang_pos", "lin_vel", "lin_pos", "z_pos", "z_vel")
    ):
        b = getattr(pids, bank)
        pids = pids.replace(**{bank: b.replace(
            integral=jax.random.normal(jax.random.fold_in(k, 2 * i), b.integral.shape),
            prev_error=jax.random.normal(jax.random.fold_in(k, 2 * i + 1), b.prev_error.shape),
        )})
    st = st.replace(pids=pids)
    packed = pallas_quadx.pack_state(st, 7)
    assert packed.shape == (pallas_quadx.ROWS_MODE7, 8, 16)
    st2 = pallas_quadx.unpack_state(packed, st)
    for bank in ("ang_vel", "ang_pos", "lin_vel", "lin_pos", "z_pos", "z_vel"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st2.pids, bank).integral),
            np.asarray(getattr(st.pids, bank).integral),
            err_msg=bank,
        )
    np.testing.assert_array_equal(np.asarray(st2.body.pos), np.asarray(st.body.pos))


def test_pack_unpack_roundtrip():
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params, n=128, seed=5)
    packed = pallas_quadx.pack_state(st)
    assert packed.shape == (pallas_quadx.ROWS, 8, 16)
    st2 = pallas_quadx.unpack_state(packed, st)
    np.testing.assert_array_equal(np.asarray(st2.body.pos), np.asarray(st.body.pos))
    np.testing.assert_array_equal(np.asarray(st2.read.view), np.asarray(st.read.view))
    np.testing.assert_array_equal(
        np.asarray(st2.contact), np.asarray(st.contact)
    )


def test_kernel_mode9_matches_xla():
    """Mode 9 (fork raw motor mix): motor_map @ setpoint with no PID."""
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params)
    sp = jax.random.uniform(
        jax.random.PRNGKey(9), (256, 4), minval=-0.05, maxval=0.05
    ).at[:, 3].set(0.4)
    st = st.replace(setpoint=sp)

    ref, _ = quadx.step(st, params, cfg, 9)
    out, _ = pallas_quadx.step(st, params, cfg, 9)
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.body.ang_vel), np.asarray(ref.body.ang_vel), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.pwm), np.asarray(ref.pwm), atol=2e-6
    )


@pytest.mark.parametrize("mode", [0, 9])
def test_kernel_ned_matches_xla(mode):
    """NED_FRD convention: the view rows carry the converted read (the body
    state stays ENU), the mode-0 z command takes the NED clip+negate path,
    and the NED motor map mixes correctly."""
    cfg = quadx.QuadXConfig(noisy_motors=False, orn_conv="NED_FRD")
    params = quadx.build_params(cfg)
    key = jax.random.PRNGKey(12)
    n = 128
    # NED spawn: z down, so altitude 5 m = -5
    pos = jax.random.uniform(key, (n, 3), minval=-2, maxval=2) + jnp.asarray(
        [0.0, 0.0, -5.0]
    )
    orn = jax.random.uniform(
        jax.random.fold_in(key, 1), (n, 3), minval=-0.3, maxval=0.3
    )
    st = quadx.init_state(params, cfg, pos, orn)
    st = quadx.set_mode(st, mode, cfg)
    if mode == 0:
        sp = jax.random.uniform(
            jax.random.fold_in(key, 2), (n, 4), minval=-0.3, maxval=0.3
        ).at[:, 3].set(-0.4)  # NED thrust command is negative
    else:
        sp = jax.random.uniform(
            jax.random.fold_in(key, 2), (n, 4), minval=-0.05, maxval=0.05
        ).at[:, 3].set(0.4)
    st = st.replace(setpoint=sp)

    ref = out = st
    for _ in range(8):
        ref, _ = quadx.step(ref, params, cfg, mode)
        out, _ = pallas_quadx.step(out, params, cfg, mode)
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.read.view), np.asarray(ref.read.view), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.pwm), np.asarray(ref.pwm), atol=1e-5
    )


def test_kernel_gaussian_wind_deterministic_matches_xla():
    """Baked gaussian wind with max_gust=0 (deterministic base wind) must
    exactly match the XLA path fed the same constant wind vector — the drag
    term sees air velocity, so a 3 m/s crosswind visibly bends the
    trajectory (also asserted)."""
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = _random_state(cfg, params, n=128, seed=5)
    st = st.replace(
        setpoint=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.42]), (128, 1))
    )
    base = (3.0, -1.5, 0.5)
    wind_fn = lambda step, p: jnp.broadcast_to(
        jnp.asarray(base, p.dtype), p.shape
    )

    ref = out = nowind = st
    for _ in range(12):
        ref, _ = quadx.step(ref, params, cfg, 0, wind_fn=wind_fn)
        nowind, _ = quadx.step(nowind, params, cfg, 0)
        out, _ = pallas_quadx.step(
            out, params, cfg, 0,
            wind={"kind": "gaussian", "base": base, "max_gust": 0.0},
        )
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.read.drag_local_vel),
        np.asarray(ref.read.drag_local_vel), atol=5e-4,
    )
    # wind actually does something
    assert (
        float(
            jnp.max(jnp.abs(ref.body.pos - nowind.body.pos))
        ) > 1e-3
    )


def test_kernel_per_env_wind_base_matches_xla():
    """wind["per_env_base"]: rows 51-53 carry a PER-LANE base wind vector
    (the quadx_mod envs draw a random GaussianWind base per env at reset,
    which a baked scalar can't represent). max_gust=0 is deterministic, so
    the kernel must exactly track the XLA path fed the same per-env wind;
    the rows must also write through so a packed carrier keeps them."""
    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    n = 128
    st = _random_state(cfg, params, n=n, seed=11)
    st = st.replace(
        setpoint=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.42]), (n, 1))
    )
    bases = jax.random.uniform(
        jax.random.PRNGKey(3), (n, 3), jnp.float32, -4.0, 4.0
    )
    wind_fn = lambda step, p: bases.astype(p.dtype)

    packed = pallas_quadx.pack_state(st, 0)
    fold = lambda x: x.T.reshape(3, 8, n // 8)
    packed = packed.at[
        pallas_quadx._WBASE : pallas_quadx._WBASE + 3
    ].set(fold(bases))

    wind = {"kind": "gaussian", "per_env_base": True, "max_gust": 0.0}
    ref = st
    seed = jnp.zeros((), jnp.int32)
    for _ in range(8):
        ref, _ = quadx.step(ref, params, cfg, 0, wind_fn=wind_fn)
        packed = pallas_quadx.packed_step(
            packed, seed, params, cfg, mode=0, noisy=False, wind=wind
        )
    out = pallas_quadx.unpack_state(packed, st)
    np.testing.assert_allclose(
        np.asarray(out.body.pos), np.asarray(ref.body.pos), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.read.drag_local_vel),
        np.asarray(ref.read.drag_local_vel), atol=5e-4,
    )
    # rows wrote through unchanged
    got = np.asarray(
        packed[pallas_quadx._WBASE : pallas_quadx._WBASE + 3]
    ).reshape(3, n)
    np.testing.assert_allclose(got.T, np.asarray(bases), atol=0)
    # distinct per-env winds produce distinct drift (not a broadcast base)
    drift = np.asarray(out.body.pos - st.body.pos)
    assert np.std(drift[:, 0]) > 1e-4
