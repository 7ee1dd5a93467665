"""Pallas kernel (Triton route): fused Fixedwing agent step (modes -1/0,
waypoints task).

The quadx treatment (ops/pallas_quadx.py) applied to the fixed-wing vehicle:
the whole drone state is packed as a folded ``(ROWS, 8, N/8)`` f32 array,
one GPU thread owns one env (ops/pallas_math.grid_call), and the entire
aviary-step chain — surface-assist control map -> actuation/throttle lag (+ noise) ->
5-surface Khan aero wrench + puller-motor wrench -> lagged state read ->
semi-implicit Euler with the full 3x3 composite inertia -> ground contact —
runs in registers.

Everything concrete at trace time is baked into the kernel as constants:

- the composite inertia AND its inverse (models/fixedwing.py:85-92), so the
  full-tensor Euler equations cost two 3x3 matvecs instead of a solve;
- every cross/matvec against a constant vector is zero-skipped
  (ops/pallas_math.py) — the vehicle's surface/motor units are axis-aligned,
  so the aero wrench collapses to ``f += fn*lu + fp*du`` and
  ``tau += qcm*tu + fn*cross(r,lu) + fp*cross(r,du)`` with CONCRETE crosses;
- the main wing's ``deflection_limit == 0`` specializes its whole flap branch
  away at trace time.

Math is identical to the XLA path (models/fixedwing.py + ops/
lifting_surfaces.py, themselves cited against /root/reference/PyFlyt/core/
drones/fixedwing.py and core/abstractions/lifting_surfaces.py:315-484), with
the same documented deviations as the quadx kernel:

- motor noise draws counter-hash normals (ops/pallas_math.HashNormal)
  instead of the threefry stream — same distribution, different sequence;
- ground contact is detection + positional projection + inelastic vertical
  stop instead of the impulse model in core/integrator.py::ground_contact —
  every fixedwing task terminates on contact, so the resolved post-contact
  state is only ever seen in the terminal observation;
- the waypoint task update rotates target deltas with the pre-integration
  rotation matrix directly: the XLA path's euler -> quat -> rotmat round trip
  (envs/fixedwing_waypoints.py:100-102) is the identity on rotations, so this
  is the same matrix up to f32 roundoff.

Validated against ``fixedwing.step`` / the XLA waypoints env in
tests/test_pallas_fixedwing.py (noise off => float32-roundoff agreement).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from pyflyt_tpu.models import fixedwing
from pyflyt_tpu.ops import pallas_math as pmk

ROWS = 88  # 87 used
SUBLANES = 8

# ---- drone rows
_POS = 0     # 3: world ENU CoM position
_QUAT = 3    # 4: xyzw body->world
_LVEL = 7    # 3: world linear velocity (CoM)
_AVEL = 10   # 3: world angular velocity
_VIEW = 13   # 12: lagged [ang_vel_b, euler, lin_vel_b(base), base_pos]
_SLV = 25    # 15: lagged body-frame surface local velocities (5 x 3)
_ACT = 40    # 5: surface deflections
_THR = 45    # 1: motor throttle
_SP = 46     # 6: setpoint (rows 4-5 zero in mode 0)
_CON = 52    # 1: contact flag (0/1)

# ---- env rows (waypoints task fusion)
_RWD = 53    # running reward of the agent step
_TERM = 54
_TRUNC = 55
_COLL = 56
_OOB = 57
_STEP = 58   # agent step count (exact as f32 below 2^24)
_CPLT = 59   # env_complete

# ---- waypoint rows: the target buffer is stored CYCLICALLY ROLLED so the
# current target is always rows _TGT.._TGT+2 (no runtime gather); the XLA
# handler's cursor form is recovered as idx = num_targets - remaining and an
# inverse roll (envs/packed_fixedwing_waypoints.py).
_TGT = 60    # 12: world-frame targets, rolled (4 x 3)
_REM = 72    # 1: remaining target count
_NDIST = 73  # 1: WaypointState.new_distance
_ODIST = 74  # 1: WaypointState.old_distance
_TDLT = 75   # 12: target_deltas observation (body frame, pre-advance, masked)

NUM_SURFACES = fixedwing.NUM_SURFACES


def pack_state(state: fixedwing.FixedwingState) -> Array:
    """Batched FixedwingState (batch (N,)) -> (ROWS, 8, N/8) f32."""
    n = state.body.pos.shape[0]
    assert n % SUBLANES == 0, n
    sp = state.setpoint
    if sp.shape[-1] < 6:
        sp = jnp.concatenate(
            [sp, jnp.zeros((n, 6 - sp.shape[-1]), sp.dtype)], axis=-1
        )
    rows = [
        state.body.pos.T,
        state.body.quat.T,
        state.body.lin_vel.T,
        state.body.ang_vel.T,
        state.read.view.reshape(n, 12).T,
        state.read.surface_local_vel.reshape(n, 15).T,
        state.actuation.T,
        state.throttle.T,
        sp.T,
        state.contact.astype(jnp.float32)[None, :],
    ]
    packed = jnp.concatenate(rows, axis=0)
    pad = ROWS - packed.shape[0]
    packed = jnp.concatenate([packed, jnp.zeros((pad, n), packed.dtype)], axis=0)
    return packed.reshape(ROWS, SUBLANES, n // SUBLANES)


def unpack_state(
    packed: Array, template: fixedwing.FixedwingState
) -> fixedwing.FixedwingState:
    """(ROWS, 8, N/8) -> FixedwingState. ``cmd`` keeps template values (it is
    recomputed from the setpoint at every control gate)."""
    packed = packed.reshape(ROWS, -1)
    g = lambda r, k: packed[r : r + k].T
    n = packed.shape[1]
    sp_dim = template.setpoint.shape[-1]
    return template.replace(
        body=template.body.replace(
            pos=g(_POS, 3), quat=g(_QUAT, 4), lin_vel=g(_LVEL, 3),
            ang_vel=g(_AVEL, 3),
        ),
        read=fixedwing.FixedwingRead(
            view=g(_VIEW, 12).reshape(n, 4, 3),
            surface_local_vel=g(_SLV, 15).reshape(n, 5, 3),
        ),
        actuation=g(_ACT, 5),
        throttle=g(_THR, 1),
        setpoint=g(_SP, sp_dim),
        contact=packed[_CON] > 0.5,
    )


def _bake(params: fixedwing.FixedwingParams, cfg: fixedwing.FixedwingConfig):
    """Concrete numpy views of every parameter the kernel bakes in."""
    p = lambda x: np.asarray(x, dtype=np.float64)
    com = p(params.com_offset)
    inertia = p(params.inertia)
    s = params.surfaces
    surf = []
    for i in range(NUM_SURFACES):
        r = p(s.positions)[i] - com
        lu = p(s.lift_unit)[i]
        du = p(s.drag_unit)[i]
        tu = p(s.torque_unit)[i]
        aspect = float(p(s.aspect)[i])
        surf.append(
            dict(
                lu=lu, du=du, tu=tu, r_s=r,
                cl1=np.cross(r, lu), cl2=np.cross(r, du),
                qa=0.5 * 1.225 * float(p(s.area)[i]),  # HALF_RHO * area
                chord=float(p(s.chord)[i]),
                piAR_inv=1.0 / (np.pi * aspect),
                f2c=float(p(s.flap_to_chord)[i]),
                eta=float(p(s.eta)[i]),
                a0b=float(p(s.alpha_0_base)[i]),
                asPb=float(p(s.alpha_stall_P_base)[i]),
                asNb=float(p(s.alpha_stall_N_base)[i]),
                cl3d=float(p(s.Cl_alpha_3D)[i]),
                cd0=float(p(s.Cd_0)[i]),
                dlim_rad=float(np.deg2rad(p(s.deflection_limit)[i])),
                atau=float(p(s.aero_tau)[i]),
                tau=float(p(s.tau)[i]),
                stall_c=0.41 * (1.0 - np.exp(-17.0 / aspect)),
            )
        )
    m = params.motor
    mu = p(m.thrust_unit)[0]
    mr = p(m.positions)[0]  # already CoM-relative (models/fixedwing.py:95)
    return dict(
        mass=float(p(params.mass)),
        inv_mass=1.0 / float(p(params.mass)),
        inertia=inertia,
        inv_inertia=np.linalg.inv(inertia),
        com=com,
        contact_pts=p(params.contact_points) - com,
        surf=surf,
        mot_f=mu * float(p(m.thrust_coef)[0]),
        mot_t=mu * float(p(m.torque_coef)[0])
        + np.cross(mr, mu) * float(p(m.thrust_coef)[0]),
        mot_tau=float(p(m.tau)[0]),
        mot_max_rpm=float(p(m.max_rpm)[0]),
        mot_noise=float(p(m.noise_ratio)[0]),
        assist_ids=np.asarray(params.assist_ids),
        assist_signs=p(params.assist_signs),
        surf_tau=[float(v) for v in p(s.tau)],
        dt=cfg.physics_period,
        ratio=cfg.physics_control_ratio,
    )


def surface_normal_forward(S, act_s, lv):
    """One lifting surface's (fn, fp, qcm) scalars from its lagged local
    velocity — the Khan-model core of lifting_surfaces.py:337-484 shared by
    the fixedwing kernel (constant lever arms) and the rocket kernel
    (register-valued, fuel-dependent lever arms — ops/pallas_rocket.py).

    Returns (fn, fp, qcm): normal-axis force, forward-axis force and pitch
    moment magnitudes to apply along ``S['lu']``/``S['du']``/``S['tu']``.
    """
    cl3d, cd0 = S["cl3d"], S["cd0"]
    lifting = pmk.dot_const(lv, S["lu"])
    forward = pmk.dot_const(lv, S["du"])
    alpha = jnp.arctan2(-lifting, forward)

    if S["dlim_rad"] != 0.0:
        defl = act_s * S["dlim_rad"]
        dCl = (cl3d * S["atau"] * S["eta"]) * defl
        dClmax = S["f2c"] * dCl
        a0 = S["a0b"] - dCl / cl3d
        asP = a0 + (cl3d * (S["asPb"] - S["a0b"]) + dClmax) / cl3d
        asN = a0 + (cl3d * (S["asNb"] - S["a0b"]) + dClmax) / cl3d
        Cd90 = (-4.26e-2 * defl * defl) + (2.1e-1 * defl) + 1.98
    else:  # flapless surface: the whole flap branch is trace-time constant
        a0 = S["a0b"]
        asP, asN = S["asPb"], S["asNb"]
        Cd90 = 1.98

    # ---- no-stall linear regime
    Cl_lin = cl3d * (alpha - a0)
    ae = alpha - a0 - Cl_lin * S["piAR_inv"]
    sae, cae = jnp.sin(ae), jnp.cos(ae)
    CT = cd0 * cae
    CN = (Cl_lin + CT * sae) / cae
    Cd_lin = CN * sae + CT * cae
    CM_lin = -CN * (0.25 - 0.175 * (1.0 - (2.0 / np.pi) * ae))

    # ---- post-stall flat-plate model
    aisP = (cl3d * (asP - a0)) * S["piAR_inv"]
    aisN = (cl3d * (asN - a0)) * S["piAR_inv"]
    tP = jnp.clip((alpha - asP) / (np.pi / 2.0 - asP), 0.0, 1.0)
    tN = jnp.clip((alpha + np.pi / 2.0) / (asN + np.pi / 2.0), 0.0, 1.0)
    ai_st = jnp.where(alpha > 0.0, aisP * (1.0 - tP), tN * aisN)
    ae_st = alpha - a0 - ai_st
    s_st, c_st = jnp.sin(ae_st), jnp.cos(ae_st)
    CN_st = (
        Cd90
        * s_st
        * (1.0 / (0.56 + 0.44 * jnp.abs(s_st)) - S["stall_c"])
    )
    CT_st = 0.5 * cd0 * c_st
    Cl_st = CN_st * c_st - CT_st * s_st
    Cd_st = CN_st * s_st + CT_st * c_st
    CM_st = -CN_st * (
        0.25 - 0.175 * (1.0 - (2.0 / np.pi) * jnp.abs(ae_st))
    )

    no_stall = (asN < alpha) & (alpha < asP)
    Cl = jnp.where(no_stall, Cl_lin, Cl_st)
    Cd = jnp.where(no_stall, Cd_lin, Cd_st)
    CM = jnp.where(no_stall, CM_lin, CM_st)

    # ---- sin/cos(alpha) algebraically (saves 2 transcendentals):
    # alpha = atan2(-lifting, forward) => cos = fwd/h, sin = -lift/h.
    free2 = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2]
    hyp2 = lifting * lifting + forward * forward
    degen = hyp2 < 1e-16
    r_inv = jax.lax.rsqrt(jnp.where(degen, 1.0, hyp2))
    sina = jnp.where(degen, 0.0, -lifting * r_inv)
    cosa = jnp.where(degen, 1.0, forward * r_inv)
    Q = S["qa"] * free2
    lift = Cl * Q
    drag = Cd * Q
    fn = lift * cosa + drag * sina
    fp = lift * sina - drag * cosa
    qcm = Q * CM * S["chord"]
    return fn, fp, qcm


def _surface_wrench(B, si, act_s, lv, f, t):
    """Adds surface ``si``'s aero wrench onto (f, t) in place — constant
    (baked) lever arms, so the torque crosses are concrete."""
    S = B["surf"][si]
    fn, fp, qcm = surface_normal_forward(S, act_s, lv)
    pmk.add_scaled(f, fn, S["lu"])
    pmk.add_scaled(f, fp, S["du"])
    pmk.add_scaled(t, qcm, S["tu"])
    pmk.add_scaled(t, fn, S["cl1"])
    pmk.add_scaled(t, fp, S["cl2"])


def _control_cmd(B, mode, sp):
    """Aviary control gate: raw actuators (mode -1) or the surface-assist map
    (fixedwing.py:137-140, 226-247)."""
    if mode == -1:
        return list(sp)
    return [
        float(B["assist_signs"][j]) * sp[int(B["assist_ids"][j])]
        for j in range(6)
    ]


def _drone_physics_iter(B, rng, d, cmd):
    """One 240 Hz physics iteration on register-resident fixedwing state.

    ``d`` maps register names to lists of per-row values: ``pos``[3],
    ``quat``[4], ``lvel``[3], ``avel``[3], ``view``[12], ``slv``[15],
    ``act``[5], ``thr``, ``contact``; mutated in place. The chain is
    models/fixedwing.py physics_iter: actuator lag -> aero + motor wrench
    from the LAGGED read -> fresh read snapshot -> semi-implicit Euler with
    the baked full 3x3 inertia -> detection-grade ground contact. Returns the
    pre-integration body->world rotation matrix (9 registers) for task use.
    Shared by the waypoints kernel below and ops/pallas_dogfight.py (which
    runs it once per drone bank of the arena lane).
    """
    dt = B["dt"]
    g = 9.81
    act, slv = d["act"], d["slv"]
    pos, quat, lvel, avel = d["pos"], d["quat"], d["lvel"], d["avel"]
    thr = d["thr"]

    # actuator lags (lifting_surfaces.py:266, motors.py:126-134)
    for si in range(5):
        act[si] = act[si] + (dt / B["surf_tau"][si]) * (cmd[si] - act[si])
    thr = thr + (dt / B["mot_tau"]) * (cmd[5] - thr)
    if rng is not None:
        thr = thr + rng.normal() * thr * B["mot_noise"]

    # wrench from the LAGGED read state
    f = [jnp.zeros_like(thr) for _ in range(3)]
    t = [jnp.zeros_like(thr) for _ in range(3)]
    for si in range(5):
        _surface_wrench(B, si, act[si], slv[3 * si : 3 * si + 3], f, t)
    rpm = thr * B["mot_max_rpm"]
    rc = rpm * rpm * jnp.sign(rpm)
    pmk.add_scaled(f, rc, B["mot_f"])
    pmk.add_scaled(t, rc, B["mot_t"])

    # rotation matrix from quat (body->world)
    R = pmk.quat_rotmat(quat)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R

    # ---- NEW read snapshot from the pre-integration state
    # (models/fixedwing.py update_state: one-iteration sensor lag)
    Rcom = [
        pmk.dot_const([r00, r01, r02], B["com"]),
        pmk.dot_const([r10, r11, r12], B["com"]),
        pmk.dot_const([r20, r21, r22], B["com"]),
    ]
    base_pos = [pos[i] - Rcom[i] for i in range(3)]
    # base_vel = v_com + omega x (-R com)
    bvx = lvel[0] - (avel[1] * Rcom[2] - avel[2] * Rcom[1])
    bvy = lvel[1] - (avel[2] * Rcom[0] - avel[0] * Rcom[2])
    bvz = lvel[2] - (avel[0] * Rcom[1] - avel[1] * Rcom[0])
    lvb = [
        r00 * bvx + r10 * bvy + r20 * bvz,
        r01 * bvx + r11 * bvy + r21 * bvz,
        r02 * bvx + r12 * bvy + r22 * bvz,
    ]
    avb = [
        r00 * avel[0] + r10 * avel[1] + r20 * avel[2],
        r01 * avel[0] + r11 * avel[1] + r21 * avel[2],
        r02 * avel[0] + r12 * avel[1] + r22 * avel[2],
    ]
    roll, pitch, yaw = pmk.quat_to_euler(quat)
    new_view = [
        avb[0], avb[1], avb[2], roll, pitch, yaw,
        lvb[0], lvb[1], lvb[2],
        base_pos[0], base_pos[1], base_pos[2],
    ]
    new_slv = []
    for si in range(5):
        # world offset of the surface link: R (r_s - r_com)
        r_s = B["surf"][si]["r_s"]
        rsw = [
            pmk.dot_const([r00, r01, r02], r_s),
            pmk.dot_const([r10, r11, r12], r_s),
            pmk.dot_const([r20, r21, r22], r_s),
        ]
        vsx = lvel[0] + (avel[1] * rsw[2] - avel[2] * rsw[1])
        vsy = lvel[1] + (avel[2] * rsw[0] - avel[0] * rsw[2])
        vsz = lvel[2] + (avel[0] * rsw[1] - avel[1] * rsw[0])
        new_slv += [
            r00 * vsx + r10 * vsy + r20 * vsz,
            r01 * vsx + r11 * vsy + r21 * vsz,
            r02 * vsx + r12 * vsy + r22 * vsz,
        ]

    # ---- integrate (semi-implicit Euler, full-tensor body Euler eqns)
    fwx = r00 * f[0] + r01 * f[1] + r02 * f[2]
    fwy = r10 * f[0] + r11 * f[1] + r12 * f[2]
    fwz = r20 * f[0] + r21 * f[1] + r22 * f[2]
    im = B["inv_mass"]
    lvel = [
        lvel[0] + dt * (fwx * im),
        lvel[1] + dt * (fwy * im),
        lvel[2] + dt * (fwz * im - g),
    ]
    ob = avb  # R^T omega_w, already computed for the read
    Iw = pmk.matvec_const(B["inertia"], ob)
    gy = [
        ob[1] * Iw[2] - ob[2] * Iw[1],
        ob[2] * Iw[0] - ob[0] * Iw[2],
        ob[0] * Iw[1] - ob[1] * Iw[0],
    ]
    rhs = [t[i] - gy[i] for i in range(3)]
    dob = pmk.matvec_const(B["inv_inertia"], rhs)
    ob = [ob[i] + dt * dob[i] for i in range(3)]
    avel = [
        r00 * ob[0] + r01 * ob[1] + r02 * ob[2],
        r10 * ob[0] + r11 * ob[1] + r12 * ob[2],
        r20 * ob[0] + r21 * ob[1] + r22 * ob[2],
    ]
    pos = [pos[i] + dt * lvel[i] for i in range(3)]
    quat = pmk.quat_integrate(quat, avel, dt)

    # ---- ground contact: detection + projection + inelastic stop
    # (full impulse model lives in core/integrator.py; contact is
    # fatal in every fixedwing task so only detection is observable)
    x, y, z, w = quat
    c20 = 2 * (x * z - w * y)
    c21 = 2 * (y * z + w * x)
    c22 = 1 - 2 * (x * x + y * y)
    zmin = None
    for pt in B["contact_pts"]:
        zp = pmk.dot_const([c20, c21, c22], pt)
        zmin = zp if zmin is None else jnp.minimum(zmin, zp)
    depth = -(pos[2] + zmin)
    hit = (depth > 0.0).astype(jnp.float32)
    pos[2] = pos[2] + hit * jnp.maximum(depth, 0.0)
    lvel = [
        lvel[0], lvel[1],
        jnp.where((hit > 0) & (lvel[2] < 0), 0.0, lvel[2]),
    ]
    d["pos"], d["quat"], d["lvel"], d["avel"] = pos, quat, lvel, avel
    d["view"], d["slv"] = new_view, new_slv
    d["thr"] = thr
    d["contact"] = hit
    return R


# registers carried through the kernel's aviary-step and physics loops
_DRONE = ("pos", "quat", "lvel", "avel", "view", "slv", "act", "thr",
          "contact", "any_contact", "R")
_ENV = ("rwd", "term", "trunc", "coll", "oobf", "cplt", "tgt", "rem",
        "ndist", "odist", "tdlt")


def _build_kernel(
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    mode: int,
    noisy: bool,
    env_fuse: dict | None = None,
):
    """Bakes the concrete parameters into a kernel body.

    ``env_fuse`` fuses the WHOLE waypoints-env agent step
    (envs/fixedwing_base.py base_step + envs/fixedwing_waypoints.py
    _task_update) into the kernel: ``inner_steps`` aviary steps with per-step
    waypoint distance tracking, reward shaping, target advancement,
    termination/truncation and the done-freeze. Keys: ``inner_steps``,
    ``dome``, ``max_steps``, ``sparse``, ``num_targets``, ``goal_dist``.
    """
    assert mode in (-1, 0), "fixedwing flight mode must be -1 or 0"
    B = _bake(params, cfg)

    if env_fuse is not None:
        NT = int(env_fuse["num_targets"])
        assert NT * 3 <= 12, "row layout carries at most 4 targets"

    def kernel(S, rng):
        rng = rng if noisy else None

        # ---- unpack mutable registers
        pos = [S[_POS + i] for i in range(3)]
        quat = [S[_QUAT + i] for i in range(4)]
        lvel = [S[_LVEL + i] for i in range(3)]
        avel = [S[_AVEL + i] for i in range(3)]
        view = [S[_VIEW + i] for i in range(12)]
        slv = [S[_SLV + i] for i in range(15)]
        act = [S[_ACT + i] for i in range(5)]
        thr = S[_THR]
        sp = [S[_SP + i] for i in range(6)]
        contact = S[_CON]
        any_contact = jnp.zeros_like(contact)

        if env_fuse is not None:
            # reward is re-armed to -0.1 unconditionally at agent-step start
            # (fixedwing_base.py base_step sets it outside the frozen scan)
            rwd = jnp.full_like(contact, -0.1)
            term = S[_TERM]
            trunc = S[_TRUNC]
            coll = S[_COLL]
            oobf = S[_OOB]
            stepc = S[_STEP]
            cplt = S[_CPLT]
            tgt = [S[_TGT + i] for i in range(12)]
            rem = S[_REM]
            ndist = S[_NDIST]
            odist = S[_ODIST]
            tdlt = [S[_TDLT + i] for i in range(12)]
            # pre-increment step count, constant across the inner loop
            # (fixedwing_base.py:123)
            trunc_hit = (stepc > float(env_fuse["max_steps"])).astype(
                jnp.float32
            )
            dome2 = float(env_fuse["dome"]) ** 2
            goal = float(env_fuse["goal_dist"])
            n_aviary = int(env_fuse["inner_steps"])
        else:
            n_aviary = 1

        def aviary_step(a, C):
            (pos, quat, lvel, avel, view, slv, act, thr, contact, any_contact,
             R) = (C[n] for n in _DRONE)
            (rwd, term, trunc, coll, oobf, cplt, tgt, rem, ndist, odist,
             tdlt) = (C.get(n) for n in _ENV)
            if env_fuse is not None:
                done_before = jnp.minimum(term + trunc, 1.0)
                snap = (
                    list(pos), list(quat), list(lvel), list(avel), list(view),
                    list(slv), list(act), thr, contact, list(tgt), rem, ndist,
                    odist, list(tdlt), rwd, term, trunc, coll, oobf, cplt,
                )
                any_contact = jnp.zeros_like(contact)

            # ------------- control once per aviary step (aviary.py:480-484)
            cmd = _control_cmd(B, mode, sp)

            def physics_iter(k, d):
                # models/fixedwing.py physics_iter, shared with the dogfight
                r = None if rng is None else rng.child(a * B["ratio"] + k)
                d["R"] = _drone_physics_iter(B, r, d, cmd)
                d["any_contact"] = jnp.maximum(d["any_contact"], d["contact"])
                return d

            L = locals()
            d = pmk.fori(B["ratio"], physics_iter, {n: L[n] for n in _DRONE})
            (pos, quat, lvel, avel, view, slv, act, thr, contact, any_contact,
             R) = (d[n] for n in _DRONE)

            if env_fuse is not None:
              # ---- fused task update (fixedwing_waypoints.py _task_update) on
              # the candidate state, then the done-freeze (fixedwing_base.py
              # base_step inner)
              lp = view[9:12]  # lagged base_pos
              # update_distances on the pre-integration rotation of the LAST
              # physics iter (== rotmat(euler_to_quat(view euler)) up to f32
              # roundoff); shared register math in pallas_math.waypoint_track
              (tgt_c, rem_c, ndist_new, odist_c, progress, tdlt_c, reached,
               all_reached) = pmk.waypoint_track(R, lp, tgt, rem, ndist, NT, goal)

              # base_term_trunc_reward (fixedwing_base.py:119-134)
              oob_i = (
                  (lp[0] * lp[0] + lp[1] * lp[1] + lp[2] * lp[2]) > dome2
              ).astype(jnp.float32)
              fatal = jnp.maximum(any_contact, oob_i)
              trunc_c = jnp.minimum(trunc + trunc_hit, 1.0)
              rwd_c = jnp.where(fatal > 0.0, -100.0, rwd)
              if not env_fuse["sparse"]:
                  rwd_c = (
                      rwd_c
                      + jnp.maximum(3.0 * progress, 0.0)
                      + 1.0 / ndist_new
                  )
              rwd_c = jnp.where(reached > 0.0, 100.0, rwd_c)
              trunc_c = jnp.minimum(trunc_c + all_reached, 1.0)
              cplt_c = jnp.minimum(cplt + all_reached, 1.0)
              term_c = jnp.minimum(term + fatal, 1.0)
              coll_c = jnp.minimum(coll + any_contact, 1.0)
              oobf_c = jnp.minimum(oobf + oob_i, 1.0)

              keep = done_before
              sel = lambda old_v, new_v: keep * old_v + (1.0 - keep) * new_v
              (s_pos, s_quat, s_lvel, s_avel, s_view, s_slv, s_act, s_thr,
               s_con, s_tgt, s_rem, s_ndist, s_odist, s_tdlt, s_rwd, s_term,
               s_trunc, s_coll, s_oobf, s_cplt) = snap
              pos = [sel(o, n_) for o, n_ in zip(s_pos, pos)]
              quat = [sel(o, n_) for o, n_ in zip(s_quat, quat)]
              lvel = [sel(o, n_) for o, n_ in zip(s_lvel, lvel)]
              avel = [sel(o, n_) for o, n_ in zip(s_avel, avel)]
              view = [sel(o, n_) for o, n_ in zip(s_view, view)]
              slv = [sel(o, n_) for o, n_ in zip(s_slv, slv)]
              act = [sel(o, n_) for o, n_ in zip(s_act, act)]
              thr = sel(s_thr, thr)
              contact = sel(s_con, contact)
              tgt = [sel(o, n_) for o, n_ in zip(s_tgt, tgt_c)]
              rem = sel(s_rem, rem_c)
              ndist = sel(s_ndist, ndist_new)
              odist = sel(s_odist, odist_c)
              tdlt = [sel(o, n_) for o, n_ in zip(s_tdlt, tdlt_c)]
              rwd = sel(s_rwd, rwd_c)
              term = sel(s_term, term_c)
              trunc = sel(s_trunc, trunc_c)
              coll = sel(s_coll, coll_c)
              oobf = sel(s_oobf, oobf_c)
              cplt = sel(s_cplt, cplt_c)


            L = locals()
            return {n: L[n] for n in carried}

        R = (jnp.zeros_like(contact),) * 9
        carried = list(_DRONE) + (list(_ENV) if env_fuse is not None else [])
        L = locals()
        C = pmk.fori(n_aviary, aviary_step, {n: L[n] for n in carried})
        (pos, quat, lvel, avel, view, slv, act, thr, contact, any_contact,
         R) = (C[n] for n in _DRONE)
        (rwd, term, trunc, coll, oobf, cplt, tgt, rem, ndist, odist,
         tdlt) = (C.get(n) for n in _ENV)

        # ---- pack back
        out = [None] * ROWS
        for i in range(3):
            out[_POS + i] = pos[i]
            out[_LVEL + i] = lvel[i]
            out[_AVEL + i] = avel[i]
        for i in range(4):
            out[_QUAT + i] = quat[i]
        for i in range(12):
            out[_VIEW + i] = view[i]
        for i in range(15):
            out[_SLV + i] = slv[i]
        for i in range(5):
            out[_ACT + i] = act[i]
        out[_THR] = thr
        for i in range(6):
            out[_SP + i] = sp[i]
        out[_CON] = contact
        if env_fuse is not None:
            out[_RWD] = rwd
            out[_TERM] = term
            out[_TRUNC] = trunc
            out[_COLL] = coll
            out[_OOB] = oobf
            out[_STEP] = stepc + 1.0  # post-scan increment, unconditional
            out[_CPLT] = cplt
            for i in range(12):
                out[_TGT + i] = tgt[i]
            out[_REM] = rem
            out[_NDIST] = ndist
            out[_ODIST] = odist
            for i in range(12):
                out[_TDLT + i] = tdlt[i]
            for i in range(ROWS):  # padding rows
                if out[i] is None:
                    out[i] = jnp.zeros_like(contact)
        else:
            zero = jnp.zeros_like(contact)
            out[_RWD] = any_contact  # spare row carries the any-contact flag
            for i in range(_RWD + 1, ROWS):
                out[i] = zero
        return out

    return kernel


def packed_step(
    packed: Array,
    seed: Array,
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    mode: int = 0,
    noisy: bool = True,
) -> Array:
    """One aviary step on the packed (ROWS, 8, N/8) state. Row ``_RWD`` of the
    output carries the any-contact flag. ``params`` must be CONCRETE (baked at
    trace time); wrap the caller in ``jax.jit``."""
    kernel = _build_kernel(params, cfg, mode, noisy)
    return pmk.grid_call(kernel, packed, seed)


def packed_waypoints_step(
    packed: Array,
    seed: Array,
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    mode: int,
    noisy: bool,
    inner_steps: int,
    dome: float,
    max_steps: int,
    goal_dist: float,
    num_targets: int = 4,
    sparse: bool = False,
) -> Array:
    """One FULL waypoints-env agent step on the packed state: ``inner_steps``
    aviary steps + waypoint tracking + reward shaping + termination/truncation
    + done-freeze, all register-resident (see
    envs/packed_fixedwing_waypoints.py)."""
    kernel = _build_kernel(
        params, cfg, mode, noisy,
        env_fuse=dict(
            inner_steps=inner_steps, dome=dome, max_steps=max_steps,
            sparse=sparse, num_targets=num_targets, goal_dist=goal_dist,
        ),
    )
    return pmk.grid_call(kernel, packed, seed)


def step(
    state: fixedwing.FixedwingState,
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    mode: int,
    key: Array | None = None,
) -> tuple[fixedwing.FixedwingState, Array]:
    """Drop-in for ``fixedwing.step`` (batched (N,) states, no wind)."""
    packed = pack_state(state)
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
    )
    new_state = unpack_state(out, state)
    new_state = new_state.replace(
        physics_steps=state.physics_steps + cfg.physics_control_ratio
    )
    return new_state, out[_RWD].reshape(-1) > 0.5
