"""Pallas kernel (Triton route): fused QuadX agent step (modes 0/7/8/9).

The XLA step stores state as ``(N, 3)``/``(N, 4)`` arrays and runs the
6-physics-iteration chain as many small fused kernels, each a round trip
through device memory. This kernel keeps the whole drone state as a folded
``(ROWS, 8, N/8)`` f32 array (env axis last), gives each GPU thread one env
(ops/pallas_math.grid_call), and runs the entire aviary-step chain — PID
cascade → motor mix → saturation → throttle lag (+ noise) → wrench → lagged
state read → semi-implicit Euler → ground contact — in registers.

Math is identical to the reference path (models/quadx.py), with two
documented deviations:
- motor noise draws counter-hash normals (ops/pallas_math.HashNormal)
  instead of the threefry stream — same distribution, different sequence;
- ground contact is detection + positional projection + inelastic vertical
  stop (the envs that use this path terminate on contact, so the reference's
  full impulse resolution is never observed).

Validated against ``quadx.step`` in tests/test_pallas_quadx.py (noise off ⇒
agreement to float32 rounding). ``packed_hover_step`` fuses the WHOLE hover
env agent step (3 aviary steps + reward/termination/freeze) into one call;
envelope: modes 0/7/8/9, ENU or NED (mode 7 ENU-only), optional baked
gaussian/simple wind fields, detection-grade contact (mode 7 carries the
full position-PID cascade in 24 extension rows — see ROWS_MODE7; the
waypoints task adds WP_ROWS more — see rows_for_waypoints).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from pyflyt_tpu.models import quadx
from pyflyt_tpu.ops import pallas_math as pmk

ROWS = 56  # 50 used (56 with env fusion)

# row layout
_POS = 0       # 3: world ENU position
_QUAT = 3      # 4: xyzw body->world
_LVEL = 7      # 3: world linear velocity
_AVEL = 10     # 3: world angular velocity
_VIEW = 13     # 12: [ang_vel_b, euler, lin_vel_b, lin_pos] (lagged)
_AVB = 25      # 3: lagged body rates
_DRG = 28     # 3: lagged body-frame air velocity
_THR = 31      # 4: motor throttle
_PWM = 35      # 4: motor pwm
_SP = 39       # 4: setpoint
_PINT = 43     # 3: ang_vel PID integral
_PPRV = 46     # 3: ang_vel PID prev error
_CON = 49      # 1: contact flag (0/1)

# ---- mode-7 extension rows (packed ONLY when mode == 7, so modes 0/8/9
# keep their 56-row footprint): the four extra PID banks of
# the position-control cascade (quadx.py:465-545)
ROWS_MODE7 = 80  # 74 used
_LP_INT = 56   # 2: lin_pos PID integral
_LP_PRV = 58   # 2: lin_pos PID prev error
_LV_INT = 60   # 2: lin_vel PID integral
_LV_PRV = 62   # 2: lin_vel PID prev error
_AP_INT = 64   # 3: ang_pos PID integral
_AP_PRV = 67   # 3: ang_pos PID prev error
_ZP_INT = 70   # 1: z_pos PID integral
_ZP_PRV = 71   # 1: z_pos PID prev error
_ZV_INT = 72   # 1: z_vel PID integral
_ZV_PRV = 73   # 1: z_vel PID prev error


def rows_for(mode: int) -> int:
    return ROWS_MODE7 if mode == 7 else ROWS


# ---- waypoint-task extension rows (envs/packed_quadx_waypoints.py), appended
# after rows_for(mode). The target buffer is stored CYCLICALLY ROLLED so the
# current target is always the first 3 rows (no runtime gather) — same scheme
# as ops/pallas_fixedwing.py. Offsets are relative to rows_for(mode):
#   +0  (12) world-frame targets, rolled (4 x 3)
#   +12 (1)  remaining-target count
#   +13 (1)  new_distance memo   +14 (1) old_distance memo
#   +15 (12) remaining_deltas observation (body frame, rolled, masked)
#   +27 (1)  env_complete flag
WP_ROWS = 28


def rows_for_waypoints(mode: int) -> int:
    n = rows_for(mode) + WP_ROWS
    return ((n + SUBLANES - 1) // SUBLANES) * SUBLANES


SUBLANES = pmk.SUBLANES  # env axis is folded (N,) -> (SUBLANES, N/SUBLANES)


def pack_state(state: quadx.QuadXState, mode: int = 0) -> Array:
    """QuadXState (batch (N,)) -> (rows_for(mode), 8, N/8) f32 (env axis
    folded). Mode 7 appends the position-cascade PID banks."""
    n = state.body.pos.shape[0]
    assert n % SUBLANES == 0, n
    rows = [
        state.body.pos.T,
        state.body.quat.T,
        state.body.lin_vel.T,
        state.body.ang_vel.T,
        state.read.view.reshape(n, 12).T,
        state.read.ang_vel_body.T,
        state.read.drag_local_vel.T,
        state.throttle.T,
        state.pwm.T,
        state.setpoint.T,
        state.pids.ang_vel.integral.T,
        state.pids.ang_vel.prev_error.T,
        state.contact.astype(jnp.float32)[None, :],
    ]
    total = rows_for(mode)
    if mode == 7:
        pids = state.pids
        rows += [
            jnp.zeros((_LP_INT - _RWD, n), rows[0].dtype),  # env rows 50-55
            pids.lin_pos.integral.T,
            pids.lin_pos.prev_error.T,
            pids.lin_vel.integral.T,
            pids.lin_vel.prev_error.T,
            pids.ang_pos.integral.T,
            pids.ang_pos.prev_error.T,
            pids.z_pos.integral.T,
            pids.z_pos.prev_error.T,
            pids.z_vel.integral.T,
            pids.z_vel.prev_error.T,
        ]
    packed = jnp.concatenate(rows, axis=0)
    pad = total - packed.shape[0]
    packed = jnp.concatenate(
        [packed, jnp.zeros((pad, n), packed.dtype)], axis=0
    )
    return packed.reshape(total, SUBLANES, n // SUBLANES)


def unpack_state(packed: Array, template: quadx.QuadXState) -> quadx.QuadXState:
    """(rows, 8, N/8) -> QuadXState (PID banks absent from the layout keep
    template values)."""
    rows = packed.shape[0]
    packed = packed.reshape(rows, -1)
    g = lambda r, k: packed[r : r + k].T
    n = packed.shape[1]
    pids = template.pids.replace(
        ang_vel=template.pids.ang_vel.replace(
            integral=g(_PINT, 3), prev_error=g(_PPRV, 3)
        )
    )
    # PID cascade banks are present only in mode-7 layouts (80 rows, or 112
    # with the waypoint extension) — mode-0/8 waypoint layouts are 88 rows
    # and their rows 56+ hold waypoint state, NOT PID banks
    if rows in (ROWS_MODE7, rows_for_waypoints(7)):
        pids = pids.replace(
            lin_pos=pids.lin_pos.replace(
                integral=g(_LP_INT, 2), prev_error=g(_LP_PRV, 2)
            ),
            lin_vel=pids.lin_vel.replace(
                integral=g(_LV_INT, 2), prev_error=g(_LV_PRV, 2)
            ),
            ang_pos=pids.ang_pos.replace(
                integral=g(_AP_INT, 3), prev_error=g(_AP_PRV, 3)
            ),
            z_pos=pids.z_pos.replace(
                integral=g(_ZP_INT, 1), prev_error=g(_ZP_PRV, 1)
            ),
            z_vel=pids.z_vel.replace(
                integral=g(_ZV_INT, 1), prev_error=g(_ZV_PRV, 1)
            ),
        )
    return template.replace(
        body=template.body.replace(
            pos=g(_POS, 3), quat=g(_QUAT, 4), lin_vel=g(_LVEL, 3),
            ang_vel=g(_AVEL, 3),
        ),
        read=template.read.replace(
            view=g(_VIEW, 12).reshape(n, 4, 3),
            ang_vel_body=g(_AVB, 3),
            drag_local_vel=g(_DRG, 3),
        ),
        throttle=g(_THR, 4),
        pwm=g(_PWM, 4),
        setpoint=g(_SP, 4),
        pids=pids,
        contact=packed[_CON] > 0.5,
        physics_steps=template.physics_steps,
    )


# env-fused row layout: the 6 spare rows carry the hover task's env fields
_RWD = 50    # running reward of the agent step
_TERM = 51   # termination flag
_TRUNC = 52  # truncation flag
_COLL = 53   # collision info flag
_OOB = 54    # out-of-bounds info flag
_STEP = 55   # agent step count (exact as f32 below 2^24)

# generic (non-env-fused) variant: row 50 is any_contact; 51-55 are spare.
# wind["per_env_base"] repurposes 51-53 for a PER-LANE wind base vector
# (core/wind.py::GaussianWind with a random base per env — the quadx_mod
# envs' reset draws one per environment, so a baked scalar base can't
# represent it). Written through by the kernel so the carrier env only
# sets them once. Incompatible with env_fuse (those rows are taken).
_WBASE = 51  # 3: per-env wind base, world frame of cfg.orn_conv


# registers carried through the kernel's aviary-step and physics loops
_DRONE = ("pos", "quat", "lvel", "avel", "view", "avb", "drg", "thr", "pwm",
          "pint", "pprv", "contact", "any_contact", "Rlast")
_ENV = ("rwd", "term", "trunc", "coll", "oobf")
_WP = ("tgt", "rem", "ndist", "odist", "tdlt", "cplt")
_PHYS = ("thr", "pos", "quat", "lvel", "avel", "view", "avb", "drg",
         "contact", "any_contact", "Rlast")


def _build_kernel(params: quadx.QuadXParams, cfg: quadx.QuadXConfig, mode: int,
                  noisy: bool, env_fuse: dict | None = None,
                  wind: dict | None = None):
    """Bakes the (concrete) parameters into a kernel body.

    ``env_fuse`` (optional) fuses the WHOLE hover-env agent step
    (envs/quadx_base.py base_step + envs/quadx_hover.py _task_update) into
    the kernel: ``inner_steps`` aviary steps with per-step reward shaping,
    termination/truncation checks and the done-freeze, keeping state
    register-resident across the loop. Keys: ``inner_steps`` (env_step_ratio),
    ``dome`` (flight_dome_size), ``max_steps``, ``sparse`` (bool).

    ``wind`` (optional) bakes a wind field into the drag computation
    (models/quadx.py update_state air_vel — the read's drag_local_vel
    becomes R^T (lin_vel - wind)). Either
    ``{"kind": "gaussian", "base": (3,) ENU, "max_gust": float}``
    (core/wind.py::GaussianWind — base + per-axis clipped unit normal,
    resampled every physics iteration) or
    ``{"kind": "simple", "strength": float}`` (SimpleWind thermal + unit
    noise). Stochastic wind uses the kernel's counter-hash normals: same
    distribution as the XLA wind models, different stream (the established
    kernel deviation class); gaussian with ``max_gust=0`` is deterministic
    and exactly matches the XLA path.
    """
    ned = cfg.orn_conv == "NED_FRD"
    per_env_wind = bool(wind is not None and wind.get("per_env_base"))
    assert not (per_env_wind and env_fuse is not None), (
        "per_env_base wind uses rows 51-53, which the env-fused variants "
        "occupy — fuse either the env or the per-env wind, not both"
    )
    assert not (per_env_wind and wind["kind"] != "gaussian"), (
        "per_env_base is a GaussianWind feature (random base per env)"
    )
    assert mode in (0, 7, 8, 9), "pallas fast path supports modes 0/7/8/9"
    assert not (ned and mode == 7), (
        "mode 7 in the kernel carries the ENU cascade (NED position modes "
        "4-6 are reference-bug territory; use the XLA path)"
    )
    assert env_fuse is None or not ned, (
        "env fusion (hover/waypoints) is ENU-only like the stock envs"
    )
    assert np.allclose(np.asarray(params.motor.thrust_unit), [0.0, 0.0, 1.0]), (
        "pallas fast path assumes +z thrust for every motor (the wrench is "
        "hand-expanded for vertical rotors); use quadx.step for tilted rotors"
    )
    p = lambda x: np.asarray(x, dtype=np.float64)
    kp = p(params.pid_ang_vel.kp)
    ki = p(params.pid_ang_vel.ki)
    kd = p(params.pid_ang_vel.kd)
    lim = p(params.pid_ang_vel.lim)
    period = float(params.pid_ang_vel.period)
    if mode == 7:
        # the position-cascade banks (quadx.py:465-545), baked per lane
        banks = {
            name: tuple(p(getattr(params, f"pid_{name}").__getattribute__(f))
                        for f in ("kp", "ki", "kd", "lim"))
            for name in ("lin_pos", "lin_vel", "ang_pos", "z_pos", "z_vel")
        }
    mmap = p(params.motor_map)  # (4, 4)
    mpos = p(params.motor.positions)  # (4, 3)
    ct = p(params.motor.thrust_coef)
    cq = p(params.motor.torque_coef)
    tau = p(params.motor.tau)
    max_rpm = p(params.motor.max_rpm)
    noise_ratio = p(params.motor.noise_ratio)
    drag_k = p(params.drag_const_xyz)
    drag_pqr = float(params.drag_coef_pqr)
    mass = float(params.mass)
    inertia = p(params.inertia)
    hx, hy, hz = [float(v) for v in p(params.collision_half_extents)]
    dt = cfg.physics_period
    min_pwm, max_pwm = cfg.min_pwm, cfg.max_pwm
    ratio = cfg.physics_control_ratio
    g = 9.81

    wind_stochastic = wind is not None and (
        wind["kind"] == "simple" or float(wind.get("max_gust", 0.0)) > 0.0
    )

    def kernel(S, rng):

        # ---- unpack mutable registers
        pos = [S[_POS + i] for i in range(3)]
        quat = [S[_QUAT + i] for i in range(4)]
        lvel = [S[_LVEL + i] for i in range(3)]
        avel = [S[_AVEL + i] for i in range(3)]
        view = [S[_VIEW + i] for i in range(12)]
        avb = [S[_AVB + i] for i in range(3)]
        drg = [S[_DRG + i] for i in range(3)]
        thr = [S[_THR + i] for i in range(4)]
        pwm = [S[_PWM + i] for i in range(4)]
        sp = [S[_SP + i] for i in range(4)]
        pint = [S[_PINT + i] for i in range(3)]
        pprv = [S[_PPRV + i] for i in range(3)]
        contact = S[_CON]
        any_contact = jnp.zeros_like(contact)
        wbase = (
            [S[_WBASE + i] for i in range(3)] if per_env_wind else None
        )

        if mode == 7:
            ext = {
                "lp": ([S[_LP_INT + i] for i in range(2)],
                       [S[_LP_PRV + i] for i in range(2)]),
                "lv": ([S[_LV_INT + i] for i in range(2)],
                       [S[_LV_PRV + i] for i in range(2)]),
                "ap": ([S[_AP_INT + i] for i in range(3)],
                       [S[_AP_PRV + i] for i in range(3)]),
                "zp": ([S[_ZP_INT]], [S[_ZP_PRV]]),
                "zv": ([S[_ZV_INT]], [S[_ZV_PRV]]),
            }

            def pid_bank(key_, bank, meas, setp):
                """Inline pid.step on the bank's register lists
                (ops/pid.py:44-58 semantics, gains baked)."""
                bkp, bki, bkd, blim = banks[bank]
                ints, prvs = ext[key_]
                outs = []
                for i in range(len(meas)):
                    err = setp[i] - meas[i]
                    ints[i] = jnp.clip(
                        ints[i] + bki[i] * err * period, -blim[i], blim[i]
                    )
                    deriv = bkd[i] * (err - prvs[i]) / period
                    prvs[i] = err
                    outs.append(
                        jnp.clip(
                            bkp[i] * err + ints[i] + deriv, -blim[i], blim[i]
                        )
                    )
                return outs

        wpf = env_fuse.get("waypoints") if env_fuse is not None else None
        if env_fuse is not None:
            # env registers (rows 50-55) + per-agent-step init: reward is
            # re-armed to -0.1 unconditionally (quadx_base.py base_step sets
            # it outside the frozen inner scan)
            rwd = jnp.full_like(contact, -0.1)
            term = S[_TERM]
            trunc = S[_TRUNC]
            coll = S[_COLL]
            oobf = S[_OOB]
            stepc = S[_STEP]
            # step-count truncation uses the PRE-increment count, constant
            # across the inner loop (quadx_base.py:138)
            trunc_hit = (stepc > float(env_fuse["max_steps"])).astype(
                jnp.float32
            )
            dome2 = float(env_fuse["dome"]) ** 2
            n_aviary = int(env_fuse["inner_steps"])
            if wpf is not None:
                # waypoint registers (envs/quadx_waypoints.py _task_update)
                WB = rows_for(mode)
                NT = int(wpf["num_targets"])
                assert NT * 3 <= 12, "row layout carries at most 4 targets"
                goal = float(wpf["goal_dist"])
                tgt = [S[WB + i] for i in range(12)]
                rem = S[WB + 12]
                ndist = S[WB + 13]
                odist = S[WB + 14]
                tdlt = [S[WB + 15 + i] for i in range(12)]
                cplt = S[WB + 27]
        else:
            n_aviary = 1

        def ext_flat():
            """All mode-7 cascade PID registers as one flat list."""
            regs = []
            for k in ("lp", "lv", "ap", "zp", "zv"):
                ints, prvs = ext[k]
                regs += list(ints) + list(prvs)
            return regs

        def ext_restore(flat):
            i = 0
            for k in ("lp", "lv", "ap", "zp", "zv"):
                ints, prvs = ext[k]
                for j in range(len(ints)):
                    ints[j] = flat[i]; i += 1
                for j in range(len(prvs)):
                    prvs[j] = flat[i]; i += 1

        def aviary_step(a, C):
            (pos, quat, lvel, avel, view, avb, drg, thr, pwm, pint, pprv,
             contact, any_contact, Rlast) = (C[n] for n in _DRONE)
            rwd, term, trunc, coll, oobf = (C.get(n) for n in _ENV)
            tgt, rem, ndist, odist, tdlt, cplt = (C.get(n) for n in _WP)
            if mode == 7:
                ext_restore(C["ext_regs"])
            if env_fuse is not None:
              done_before = jnp.minimum(jnp.maximum(term, trunc), 1.0)
              snap = (
                  list(pos), list(quat), list(lvel), list(avel), list(view),
                  list(avb), list(drg), list(thr), list(pwm), list(pint),
                  list(pprv), contact, rwd, term, trunc, coll, oobf,
              )
              snap_ext = ext_flat() if mode == 7 else None
              if wpf is not None:
                  snap_wp = (
                      list(tgt), rem, ndist, odist, list(tdlt), cplt,
                  )
              any_contact = jnp.zeros_like(contact)

            # ---------------- control (aviary.py:480-484), once per
            # aviary step, before its physics iterations
            if mode == 8:
                # direct PWM (quadx.py:452-454); saturation still applies
                raw = [sp[0], sp[1], sp[2], sp[3]]
            elif mode == 9:
                # raw motor mix (fork mode): motor_map @ setpoint, no
                # PID, no z clip (models/quadx.py:377-378)
                raw = [
                    mmap[m, 0] * sp[0] + mmap[m, 1] * sp[1]
                    + mmap[m, 2] * sp[2] + mmap[m, 3] * sp[3]
                    for m in range(4)
                ]
            else:  # modes 0/7: PID cascade + z clip (quadx.py:465-561)
                if mode == 7:
                    # position cascade: lin_pos -> yaw frame -> lin_vel
                    # -> axis swap -> ang_pos, z_pos -> z_vel
                    xy = pid_bank(
                        "lp", "lin_pos",
                        [view[9], view[10]], [sp[0], sp[1]],
                    )
                    cy, sy = jnp.cos(view[5]), jnp.sin(view[5])
                    xy = [cy * xy[0] + sy * xy[1],
                          -sy * xy[0] + cy * xy[1]]
                    xy = pid_bank("lv", "lin_vel", [view[6], view[7]], xy)
                    xy = [-xy[1], xy[0]]  # ENU swap (quadx.py:472-515)
                    a_sp = pid_bank(
                        "ap", "ang_pos",
                        [view[3], view[4], view[5]],
                        [xy[0], xy[1], sp[2]],
                    )
                    z1 = pid_bank("zp", "z_pos", [view[11]], [sp[3]])
                    z1 = pid_bank("zv", "z_vel", [view[8]], z1)
                    z_cmd = jnp.clip(z1[0], 0.0, 1.0)
                else:  # mode 0: setpoint IS the ang_vel command
                    a_sp = [sp[0], sp[1], sp[2]]
                    if ned:
                        # clip(z, -1, 0) then negate (quadx.py:425+441)
                        z_cmd = jnp.clip(
                            -jnp.clip(sp[3], -1.0, 0.0), 0.0, 1.0
                        )
                    else:
                        z_cmd = jnp.clip(sp[3], 0.0, 1.0)
                cmd = []
                for i in range(3):
                    err = a_sp[i] - view[0 + i]  # view rows 0-2 = ang_vel
                    pint[i] = jnp.clip(
                        pint[i] + ki[i] * err * period, -lim[i], lim[i]
                    )
                    deriv = kd[i] * (err - pprv[i]) / period
                    pprv[i] = err
                    cmd.append(
                        jnp.clip(kp[i] * err + pint[i] + deriv, -lim[i], lim[i])
                    )
                cmd.append(z_cmd)
                raw = [
                    mmap[m, 0] * cmd[0] + mmap[m, 1] * cmd[1]
                    + mmap[m, 2] * cmd[2] + mmap[m, 3] * cmd[3]
                    for m in range(4)
                ]
            # saturation rescale (quadx.py:553-561)
            high = jnp.maximum(jnp.maximum(raw[0], raw[1]),
                               jnp.maximum(raw[2], raw[3]))
            low = jnp.minimum(jnp.minimum(raw[0], raw[1]),
                              jnp.minimum(raw[2], raw[3]))
            pmax = jnp.minimum(high, max_pwm)
            pmin = jnp.maximum(low, min_pwm)
            dh = jnp.where(high != low, pmax - low, 1.0)
            dl = jnp.where(high != low, high - pmin, 1.0)
            pwm = [
                jnp.clip(
                    jnp.where(
                        high != low,
                        r + (pmin - low) / dh * (pmax - r)
                        - (high - pmax) / dl * (r - pmin),
                        r,
                    ),
                    min_pwm,
                    max_pwm,
                )
                for r in raw
            ]


            def physics_iter(k, P):
                (thr, pos, quat, lvel, avel, view, avb, drg, contact,
                 any_contact, Rlast) = (P[n] for n in _PHYS)
                rng_k = rng.child(a * ratio + k) if noisy or wind_stochastic else None
                # ---------------- physics iteration (models/quadx.py physics_iter)
                # motor throttle lag + noise
                if noisy:
                    nrm = [rng_k.normal() for _ in range(4)]
                for m in range(4):
                    thr[m] = thr[m] + (dt / tau[m]) * (pwm[m] - thr[m])
                    if noisy:
                        thr[m] = thr[m] + nrm[m] * thr[m] * noise_ratio[m]

                # wrench from the LAGGED read state
                fz = jnp.zeros_like(thr[0])
                tx = jnp.zeros_like(thr[0])
                ty = jnp.zeros_like(thr[0])
                tz = jnp.zeros_like(thr[0])
                for m in range(4):
                    rpm = thr[m] * max_rpm[m]
                    rc = rpm * rpm * jnp.sign(rpm)
                    f = rc * ct[m]
                    fz = fz + f
                    tx = tx + mpos[m][1] * f  # r × F for F along +z
                    ty = ty - mpos[m][0] * f
                    tz = tz + rc * cq[m]
                fdx = -jnp.sign(drg[0]) * drag_k[0] * drg[0] * drg[0]
                fdy = -jnp.sign(drg[1]) * drag_k[1] * drg[1] * drg[1]
                fdz = -jnp.sign(drg[2]) * drag_k[2] * drg[2] * drg[2]
                nc = 1.0 - contact
                tx = tx - nc * jnp.sign(avb[0]) * drag_pqr * avb[0] * avb[0]
                ty = ty - nc * jnp.sign(avb[1]) * drag_pqr * avb[1] * avb[1]
                tz = tz - nc * jnp.sign(avb[2]) * drag_pqr * avb[2] * avb[2]
                fx, fy, fz = fdx, fdy, fz + fdz

                # rotation matrix from quat (body->world)
                x, y, z, w = quat
                r00 = 1 - 2 * (y * y + z * z); r01 = 2 * (x * y - w * z); r02 = 2 * (x * z + w * y)
                r10 = 2 * (x * y + w * z); r11 = 1 - 2 * (x * x + z * z); r12 = 2 * (y * z - w * x)
                r20 = 2 * (x * z - w * y); r21 = 2 * (y * z + w * x); r22 = 1 - 2 * (x * x + y * y)

                # ---- NEW read snapshot (pre-integration state; quadx update_state)
                lvb = [r00 * lvel[0] + r10 * lvel[1] + r20 * lvel[2],
                       r01 * lvel[0] + r11 * lvel[1] + r21 * lvel[2],
                       r02 * lvel[0] + r12 * lvel[1] + r22 * lvel[2]]
                avb_new = [r00 * avel[0] + r10 * avel[1] + r20 * avel[2],
                           r01 * avel[0] + r11 * avel[1] + r21 * avel[2],
                           r02 * avel[0] + r12 * avel[1] + r22 * avel[2]]
                # euler from quat (pm.quat_to_euler)
                roll, pitch, yaw = pmk.quat_to_euler(quat)
                if ned:
                    # NED/FRD read convention (models/quadx.py update_state:
                    # flu_vec_to_frd on body rates/vels, enu_euler_to_ned,
                    # enu_pos_to_ned); the body state itself stays ENU
                    new_view = [
                        avb_new[0], -avb_new[1], -avb_new[2],
                        roll, -pitch, (np.pi / 2.0) - yaw,
                        lvb[0], -lvb[1], -lvb[2],
                        pos[1], pos[0], -pos[2],
                    ]
                else:
                    new_view = [
                        avb_new[0], avb_new[1], avb_new[2], roll, pitch, yaw,
                        lvb[0], lvb[1], lvb[2], pos[0], pos[1], pos[2],
                    ]
                if wind is None:
                    new_drg = lvb
                else:
                    # air velocity = world lin_vel - wind, rotated body-frame
                    # (models/quadx.py update_state air_vel)
                    if wind["kind"] == "gaussian":
                        wb = (
                            wbase
                            if per_env_wind
                            else [float(v) for v in wind["base"]]
                        )
                        mg = float(wind.get("max_gust", 0.0))
                        if mg > 0.0:
                            wv = [
                                wb[i]
                                + jnp.clip(rng_k.normal(), -mg, mg)
                                for i in range(3)
                            ]
                        else:
                            wv = wb
                    else:  # simple thermal (core/wind.py::SimpleWind)
                        strength = float(wind["strength"])
                        height = jnp.maximum(pos[2] + 1.0, 0.0)
                        thermal = jnp.where(
                            height > 0.0,
                            jnp.log(jnp.maximum(height, 1e-12)) * strength,
                            0.0,
                        )
                        wv = [
                            rng_k.normal(),
                            rng_k.normal(),
                            thermal + rng_k.normal(),
                        ]
                    ax = lvel[0] - wv[0]
                    ay = lvel[1] - wv[1]
                    az = lvel[2] - wv[2]
                    new_drg = [
                        r00 * ax + r10 * ay + r20 * az,
                        r01 * ax + r11 * ay + r21 * az,
                        r02 * ax + r12 * ay + r22 * az,
                    ]

                # ---- integrate (semi-implicit Euler, body-frame Euler eqns)
                fwx = r00 * fx + r01 * fy + r02 * fz
                fwy = r10 * fx + r11 * fy + r12 * fz
                fwz = r20 * fx + r21 * fy + r22 * fz
                lvel = [lvel[0] + dt * (fwx / mass),
                        lvel[1] + dt * (fwy / mass),
                        lvel[2] + dt * (fwz / mass - g)]
                ob = [r00 * avel[0] + r10 * avel[1] + r20 * avel[2],
                      r01 * avel[0] + r11 * avel[1] + r21 * avel[2],
                      r02 * avel[0] + r12 * avel[1] + r22 * avel[2]]
                gx = ob[1] * inertia[2] * ob[2] - ob[2] * inertia[1] * ob[1]
                gy = ob[2] * inertia[0] * ob[0] - ob[0] * inertia[2] * ob[2]
                gz = ob[0] * inertia[1] * ob[1] - ob[1] * inertia[0] * ob[0]
                ob = [ob[0] + dt * (tx - gx) / inertia[0],
                      ob[1] + dt * (ty - gy) / inertia[1],
                      ob[2] + dt * (tz - gz) / inertia[2]]
                avel = [r00 * ob[0] + r01 * ob[1] + r02 * ob[2],
                        r10 * ob[0] + r11 * ob[1] + r12 * ob[2],
                        r20 * ob[0] + r21 * ob[1] + r22 * ob[2]]
                pos = [pos[0] + dt * lvel[0], pos[1] + dt * lvel[1],
                       pos[2] + dt * lvel[2]]
                # quaternion integration: exact exponential map
                thx, thy, thz = avel[0] * dt, avel[1] * dt, avel[2] * dt
                sq = thx * thx + thy * thy + thz * thz
                small = sq < 1e-16
                ang = jnp.sqrt(jnp.where(small, 1.0, sq))
                half = 0.5 * ang
                sinc = jnp.where(small, 0.5 - sq / 48.0, jnp.sin(half) / ang)
                ch = jnp.where(small, 1.0 - sq / 8.0, jnp.cos(half))
                dx, dy, dz, dw = thx * sinc, thy * sinc, thz * sinc, ch
                nx = dw * x + dx * w + dy * z - dz * y
                ny = dw * y - dx * z + dy * w + dz * x
                nz = dw * z + dx * y - dy * x + dz * w
                nw = dw * w - dx * x - dy * y - dz * z
                norm = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz + nw * nw)
                quat = [nx * norm, ny * norm, nz * norm, nw * norm]

                # ---- ground contact: exact box support point along -z
                x, y, z, w = quat
                a20 = jnp.abs(2 * (x * z - w * y))
                a21 = jnp.abs(2 * (y * z + w * x))
                a22 = jnp.abs(1 - 2 * (x * x + y * y))
                extent = a20 * hx + a21 * hy + a22 * hz
                depth = extent - pos[2]
                hit = (depth > 0.0).astype(jnp.float32)
                pos[2] = pos[2] + hit * jnp.maximum(depth, 0.0)
                # inelastic vertical stop (detection-grade resolution)
                lvel = [lvel[0], lvel[1],
                        jnp.where((hit > 0) & (lvel[2] < 0), 0.0, lvel[2])]
                contact = hit
                any_contact = jnp.maximum(any_contact, hit)
                view = new_view
                avb = avb_new
                drg = new_drg
                # pre-integration rotation of this iteration: after the last
                # iteration it equals rotmat(euler_to_quat(view euler)) up to f32
                # roundoff (the waypoint task update rotates deltas with it)
                Rlast = (r00, r01, r02, r10, r11, r12, r20, r21, r22)

                L = locals()
                return {n: L[n] for n in _PHYS}

            L = locals()
            P = pmk.fori(ratio, physics_iter, {n: L[n] for n in _PHYS})
            (thr, pos, quat, lvel, avel, view, avb, drg, contact,
             any_contact, Rlast) = (P[n] for n in _PHYS)
            if env_fuse is not None:
              # ---- fused task update (quadx_hover.py / quadx_waypoints.py
              # _task_update) on the candidate state, then the done-freeze
              # (quadx_base.py:220-232)
              vx, vy, vz = view[9], view[10], view[11]  # lagged lin_pos
              oob_i = ((vx * vx + vy * vy + vz * vz) > dome2).astype(
                  jnp.float32
              )
              fatal = jnp.maximum(any_contact, oob_i)
              trunc_c = jnp.minimum(trunc + trunc_hit, 1.0)
              rwd_c = jnp.where(fatal > 0.0, -100.0, rwd)
              if wpf is None:
                  if not env_fuse["sparse"]:
                      dxt, dyt, dzt = vx, vy, vz - 1.0
                      lin_d = jnp.sqrt(dxt * dxt + dyt * dyt + dzt * dzt)
                      ang_d = jnp.sqrt(view[3] * view[3] + view[4] * view[4])
                      rwd_c = rwd_c - lin_d - ang_d + 1.0
              else:
                  # waypoint tracking (quadx_waypoints.py:102-135 +
                  # envs/utils/waypoints.py) on the pre-integration rotation;
                  # shared register math in pallas_math.waypoint_track
                  (tgt_c, rem_c, ndist_new, odist_c, progress, tdlt_c,
                   reached, all_reached) = pmk.waypoint_track(
                      Rlast, (vx, vy, vz), tgt, rem, ndist, NT, goal
                  )
                  if not env_fuse["sparse"]:
                      rwd_c = (
                          rwd_c
                          + jnp.maximum(3.0 * progress, 0.0)
                          + 0.1 / ndist_new
                      )
                  rwd_c = jnp.where(reached > 0.0, 100.0, rwd_c)
                  trunc_c = jnp.minimum(trunc_c + all_reached, 1.0)
                  cplt_c = jnp.minimum(cplt + all_reached, 1.0)
              term_c = jnp.minimum(term + fatal, 1.0)
              coll_c = jnp.minimum(coll + any_contact, 1.0)
              oobf_c = jnp.minimum(oobf + oob_i, 1.0)
              keep = done_before
              sel = lambda old_v, new_v: keep * old_v + (1.0 - keep) * new_v
              (s_pos, s_quat, s_lvel, s_avel, s_view, s_avb, s_drg, s_thr,
               s_pwm, s_pint, s_pprv, s_con, s_rwd, s_term, s_trunc, s_coll,
               s_oobf) = snap
              pos = [sel(o, n_) for o, n_ in zip(s_pos, pos)]
              quat = [sel(o, n_) for o, n_ in zip(s_quat, quat)]
              lvel = [sel(o, n_) for o, n_ in zip(s_lvel, lvel)]
              avel = [sel(o, n_) for o, n_ in zip(s_avel, avel)]
              view = [sel(o, n_) for o, n_ in zip(s_view, view)]
              avb = [sel(o, n_) for o, n_ in zip(s_avb, avb)]
              drg = [sel(o, n_) for o, n_ in zip(s_drg, drg)]
              thr = [sel(o, n_) for o, n_ in zip(s_thr, thr)]
              pwm = [sel(o, n_) for o, n_ in zip(s_pwm, pwm)]
              pint = [sel(o, n_) for o, n_ in zip(s_pint, pint)]
              pprv = [sel(o, n_) for o, n_ in zip(s_pprv, pprv)]
              if mode == 7:
                  ext_restore(
                      [sel(o, n_) for o, n_ in zip(snap_ext, ext_flat())]
                  )
              contact = sel(s_con, contact)
              rwd = sel(s_rwd, rwd_c)
              term = sel(s_term, term_c)
              trunc = sel(s_trunc, trunc_c)
              coll = sel(s_coll, coll_c)
              oobf = sel(s_oobf, oobf_c)
              if wpf is not None:
                  (s_tgt, s_rem, s_ndist, s_odist, s_tdlt, s_cplt) = snap_wp
                  tgt = [sel(o, n_) for o, n_ in zip(s_tgt, tgt_c)]
                  rem = sel(s_rem, rem_c)
                  ndist = sel(s_ndist, ndist_new)
                  odist = sel(s_odist, odist_c)
                  tdlt = [sel(o, n_) for o, n_ in zip(s_tdlt, tdlt_c)]
                  cplt = sel(s_cplt, cplt_c)

            ext_regs = ext_flat() if mode == 7 else None
            L = locals()
            return {n: L[n] for n in carried}

        Rlast = (jnp.zeros_like(contact),) * 9
        ext_regs = ext_flat() if mode == 7 else None
        carried = list(_DRONE)
        if env_fuse is not None:
            carried += list(_ENV) + (list(_WP) if wpf is not None else [])
        if mode == 7:
            carried.append("ext_regs")
        L = locals()
        C = pmk.fori(n_aviary, aviary_step, {n: L[n] for n in carried})
        (pos, quat, lvel, avel, view, avb, drg, thr, pwm, pint, pprv,
         contact, any_contact, Rlast) = (C[n] for n in _DRONE)
        rwd, term, trunc, coll, oobf = (C.get(n) for n in _ENV)
        tgt, rem, ndist, odist, tdlt, cplt = (C.get(n) for n in _WP)
        if mode == 7:
            ext_restore(C["ext_regs"])

        # ---- pack back
        out = [None] * (
            rows_for_waypoints(mode) if wpf is not None else rows_for(mode)
        )
        for i in range(3):
            out[_POS + i] = pos[i]
            out[_LVEL + i] = lvel[i]
            out[_AVEL + i] = avel[i]
            out[_AVB + i] = avb[i]
            out[_DRG + i] = drg[i]
            out[_PINT + i] = pint[i]
            out[_PPRV + i] = pprv[i]
        for i in range(4):
            out[_QUAT + i] = quat[i]
            out[_THR + i] = thr[i]
            out[_PWM + i] = pwm[i]
            out[_SP + i] = sp[i]
        for i in range(12):
            out[_VIEW + i] = view[i]
        out[_CON] = contact
        if env_fuse is not None:
            out[_RWD] = rwd
            out[_TERM] = term
            out[_TRUNC] = trunc
            out[_COLL] = coll
            out[_OOB] = oobf
            out[_STEP] = stepc + 1.0  # post-scan increment, unconditional
            if wpf is not None:
                WB = rows_for(mode)
                for i in range(12):
                    out[WB + i] = tgt[i]
                out[WB + 12] = rem
                out[WB + 13] = ndist
                out[WB + 14] = odist
                for i in range(12):
                    out[WB + 15 + i] = tdlt[i]
                out[WB + 27] = cplt
        else:
            out[_CON + 1] = any_contact
            if per_env_wind:
                for i in range(3):
                    out[_WBASE + i] = wbase[i]
        if mode == 7:
            flat = ext_flat()
            base_rows = [
                _LP_INT, _LP_INT + 1, _LP_PRV, _LP_PRV + 1,
                _LV_INT, _LV_INT + 1, _LV_PRV, _LV_PRV + 1,
                _AP_INT, _AP_INT + 1, _AP_INT + 2,
                _AP_PRV, _AP_PRV + 1, _AP_PRV + 2,
                _ZP_INT, _ZP_PRV, _ZV_INT, _ZV_PRV,
            ]
            for r, v in zip(base_rows, flat):
                out[r] = v
        return out

    return kernel


def packed_step(
    packed: Array,
    seed: Array,
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    mode: int = 0,
    noisy: bool = True,
    wind: dict | None = None,
) -> Array:
    """One aviary step on the packed (ROWS, 8, N/8) state. Row ``_CON + 1``
    of the output carries the any-contact flag for the step.

    ``params`` must be CONCRETE (the numeric values are baked into the kernel
    at trace time) — pass the env's cached parameter pytree, captured by
    closure, not a traced argument. Wrap the caller in ``jax.jit``.
    """
    kernel = _build_kernel(params, cfg, mode, noisy, wind=wind)
    return pmk.grid_call(kernel, packed, seed)


def packed_hover_step(
    packed: Array,
    seed: Array,
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    mode: int,
    noisy: bool,
    inner_steps: int,
    dome: float,
    max_steps: int,
    sparse: bool = False,
) -> Array:
    """One FULL hover-env agent step on the packed (ROWS, 8, N/8) state:
    ``inner_steps`` aviary steps + reward shaping + termination/truncation +
    done-freeze, all register-resident (see envs/packed_hover.py).
    """
    kernel = _build_kernel(
        params, cfg, mode, noisy,
        env_fuse=dict(
            inner_steps=inner_steps, dome=dome, max_steps=max_steps,
            sparse=sparse,
        ),
    )
    return pmk.grid_call(kernel, packed, seed)


def packed_waypoints_step(
    packed: Array,
    seed: Array,
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    mode: int,
    noisy: bool,
    inner_steps: int,
    dome: float,
    max_steps: int,
    num_targets: int,
    goal_dist: float,
    sparse: bool = False,
) -> Array:
    """One FULL waypoints-env agent step on the packed
    (rows_for_waypoints(mode), 8, N/8) state: ``inner_steps`` aviary steps +
    per-step waypoint distance tracking, reward shaping, target advancement,
    termination/truncation and done-freeze (see
    envs/packed_quadx_waypoints.py)."""
    kernel = _build_kernel(
        params, cfg, mode, noisy,
        env_fuse=dict(
            inner_steps=inner_steps, dome=dome, max_steps=max_steps,
            sparse=sparse,
            waypoints=dict(num_targets=num_targets, goal_dist=goal_dist),
        ),
    )
    return pmk.grid_call(kernel, packed, seed)


def step(
    state: quadx.QuadXState,
    params: quadx.QuadXParams,
    cfg: quadx.QuadXConfig,
    mode: int,
    key: Array | None = None,
    wind: dict | None = None,
) -> tuple[quadx.QuadXState, Array]:
    """Drop-in for ``quadx.step`` (batched (N,) states, modes 0/7/8/9, ENU
    or NED; ``wind`` bakes a gaussian/simple wind field — see
    ``_build_kernel``)."""
    packed = pack_state(state, mode)
    if key is not None and key.ndim == 2:
        key = key[0]
    seed = (
        jax.random.randint(key, (), 0, 2**31 - 1)
        if key is not None
        else jnp.zeros((), jnp.int32)
    )
    out = packed_step(
        packed, seed, params, cfg, mode=mode,
        noisy=cfg.noisy_motors and key is not None,
        wind=wind,
    )
    new_state = unpack_state(out, state)
    new_state = new_state.replace(
        physics_steps=state.physics_steps + cfg.physics_control_ratio
    )
    return new_state, out[_CON + 1].reshape(-1) > 0.5
