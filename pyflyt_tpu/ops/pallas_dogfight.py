"""Pallas kernel: fused 2-agent Fixedwing dogfight agent step.

Layout: one ARENA per folded lane element (one arena per thread on the GPU).
Drone 0's bank sits in rows ``[0, DR)`` and drone 1's in ``[DR, 2 DR)``: the
single-drone ops/pallas_fixedwing.py bank (53 rows) plus 13 per-drone
engagement/episode rows each. The partner's value of any register is the
same row of the other bank, so the engagement math needs no data exchange
between threads.

One kernel call runs the WHOLE dogfight agent step (``inner_steps`` aviary
steps x ``physics_control_ratio`` physics iterations per drone, engagement
rewards with the reference's one-step memo lag, termination/truncation
accumulation).

Reference semantics covered (cited against the upstream tree; the XLA
re-implementation with per-line citations is envs/ma_fixedwing_dogfight.py,
itself built against
/root/reference/PyFlyt/pz_envs/fixedwing_envs/ma_fixedwing_dogfight_env.py):

- gun origin 0.35 m behind the CG along the forward vector (:178-179)
- hit iff angle < lethal_angle AND distance < lethal_distance AND chasing
  (:199-204); health -= damage_per_hit per hit (:206)
- engagement rewards (:265-295) computed from the PREVIOUS aviary step's
  hits/angles/distance (the reference's reward memo fires before its state
  memo, :306-313 before :259-263)
- -3000 on collision (ground | mutual sphere proximity) or out-of-dome, term
  on either or on fewer than 2 agents at step start (:316-320)
- the 30-dim observation pair is assembled OUTSIDE the kernel
  (envs/packed_dogfight.py) from the final packed state — the per-aviary-step
  observation cache of the reference is only ever read after the last inner
  step, so only health/angle/distance memos live in kernel registers.

Deviations (same class as the quadx/fixedwing kernels): counter-hash noise
for the motors (same distribution, different stream than threefry);
detection-grade ground contact; the gun angle is acos as pi/2 - asin.

Parity with the vmapped XLA env (noise off) is asserted in
tests/test_pallas_dogfight.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from pyflyt_tpu.models import fixedwing
from pyflyt_tpu.ops import pallas_fixedwing as pfw
from pyflyt_tpu.ops import pallas_math as pmk

SUBLANES = 8
D_ROWS = 53  # the drone bank: pfw rows _POS.._CON (52) inclusive

# ---- per-drone engagement/episode rows (arena-shared values duplicated)
_HP = D_ROWS      # own health
_ANG = _HP + 1    # own current_angles memo
_PANG = _ANG + 1  # own prev_angles memo (one aviary step older)
_HIT = _PANG + 1  # own current_hits memo (0/1)
_DIST = _HIT + 1  # arena distance memo (same value in both drones)
_PDIST = _DIST + 1
_TERM = _PDIST + 1
_TRUNC = _TERM + 1
_RWD = _TRUNC + 1   # reward accumulated over the agent step
_COLLF = _RWD + 1   # any-collision info flag (this step)
_OOBF = _COLLF + 1  # any-out-of-bounds info flag (this step)
_OTHD = _OOBF + 1   # other-dead flag (wrapper-computed at step start)
_STEPC = _OTHD + 1  # agent step count (pre-increment)

DR = _STEPC + 1  # rows per drone bank (66)

# registers carried through the kernel's aviary-step loop
_CARRY = ("d", "hp", "ang", "pang", "hit", "dist", "pdist", "term", "trunc",
          "rwd", "collf", "oobf")
ROWS = 2 * DR    # drone m's row r lives at m * DR + r


def _build_kernel(
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    noisy: bool,
    fuse: dict,
):
    """Bakes the arena step. ``fuse`` keys: ``inner_steps`` (env_step_ratio),
    ``dome``, ``max_steps``, ``lethal_angle``, ``lethal_distance``,
    ``damage_per_hit``, ``collision_radius``, ``sparse``."""
    B = pfw._bake(params, cfg)

    inner = int(fuse["inner_steps"])
    dome2 = float(fuse["dome"]) ** 2
    max_steps = float(fuse["max_steps"])
    lethal_a = float(fuse["lethal_angle"])
    lethal_d = float(fuse["lethal_distance"])
    dph = float(fuse["damage_per_hit"])
    crad2 = (2.0 * float(fuse["collision_radius"])) ** 2
    sparse = bool(fuse["sparse"])
    M = (0, 1)

    def kernel(S, rng):
        rng = rng if noisy else None

        def bank(m):
            o = m * DR
            return {
                "pos": [S[o + pfw._POS + i] for i in range(3)],
                "quat": [S[o + pfw._QUAT + i] for i in range(4)],
                "lvel": [S[o + pfw._LVEL + i] for i in range(3)],
                "avel": [S[o + pfw._AVEL + i] for i in range(3)],
                "view": [S[o + pfw._VIEW + i] for i in range(12)],
                "slv": [S[o + pfw._SLV + i] for i in range(15)],
                "act": [S[o + pfw._ACT + i] for i in range(5)],
                "thr": S[o + pfw._THR],
                "sp": [S[o + pfw._SP + i] for i in range(6)],
                "contact": S[o + pfw._CON],
            }

        d = [bank(m) for m in M]
        row = lambda r: [S[m * DR + r] for m in M]
        hp, ang, pang, hit = row(_HP), row(_ANG), row(_PANG), row(_HIT)
        dist, pdist, othd, stepc = row(_DIST), row(_PDIST), row(_OTHD), row(_STEPC)
        zero = jnp.zeros_like(dist[0])
        term = [zero, zero]
        trunc = [zero, zero]
        rwd = [zero, zero]
        collf = [zero, zero]
        oobf = [zero, zero]
        # step_count is pre-increment and constant across the inner loop
        # (ma_fixedwing_dogfight.py:332 uses st.step_count > max_steps)
        trunc_hit = [(stepc[m] > max_steps).astype(jnp.float32) for m in M]

        # setpoints are written once per agent step, so the mode-0 assist
        # command is constant across the inner loop (aviary set_mode(0)
        # quirk: even 6-dim unassisted actions use this map — see
        # envs/ma_fixedwing_dogfight.py action_size docstring)
        cmd = [pfw._control_cmd(B, 0, d[m]["sp"]) for m in M]

        def aviary_step(a, C):
            (d, hp, ang, pang, hit, dist, pdist, term, trunc, rwd, collf,
             oobf) = (C[n] for n in _CARRY)
            # ---- engagement rewards FIRST, from the PREVIOUS aviary step's
            # memos (ma_fixedwing_dogfight_env.py:306-313 fires the reward
            # memo before the state memo). Per-drone symmetric: own angle
            # memos + the partner's hit memo.
            r_step = []
            for m in M:
                if sparse:
                    r = zero
                else:
                    in_range = (dist[m] < lethal_d).astype(jnp.float32)
                    closing = jnp.maximum(pdist[m] - dist[m], 0.0)
                    chasing = (jnp.abs(ang[m]) < (np.pi / 2.0)).astype(
                        jnp.float32
                    )
                    r = (
                        closing * (1.0 - in_range) * chasing
                        + (pang[m] - ang[m]) * in_range * 10.0
                        + 3.0 / (ang[m] + 0.1) * in_range
                    )
                r_step.append(r + 30.0 * hit[m] - 20.0 * hit[1 - m])

            # ---- physics: one aviary step for each drone
            def physics_iter(k, P):
                d, c = P
                for m in M:
                    r = None if rng is None else rng.child(
                        (a * B["ratio"] + k) * 2 + m
                    )
                    pfw._drone_physics_iter(B, r, d[m], cmd[m])
                    c[m] = jnp.maximum(c[m], d[m]["contact"])
                return d, c

            d, c = pmk.fori(B["ratio"], physics_iter, (d, [zero, zero]))

            # ---- _agent_states (ma_fixedwing_dogfight_env.py:164-207):
            # forward vector from the lagged euler read, own gun position,
            # separation toward the partner
            gun, fwd = [], []
            for m in M:
                v = d[m]["view"]
                cp = jnp.cos(v[4])
                f = [jnp.cos(v[5]) * cp, jnp.sin(v[5]) * cp, -jnp.sin(v[4])]
                fwd.append(f)
                gun.append([v[9 + k] - 0.35 * f[k] for k in range(3)])
            hit_new = []
            for m in M:
                sep = [gun[1 - m][k] - gun[m][k] for k in range(3)]
                d2 = sep[0] * sep[0] + sep[1] * sep[1] + sep[2] * sep[2]
                dist_new = jnp.sqrt(d2)
                inv_d = 1.0 / jnp.maximum(dist_new, 1e-8)
                dot = sep[0] * fwd[m][0] + sep[1] * fwd[m][1] + sep[2] * fwd[m][2]
                ang_new = (np.pi / 2.0) - pmk.asin(dot * inv_d)
                in_range_new = (dist_new < lethal_d).astype(jnp.float32)
                hit_new.append(
                    (ang_new < lethal_a).astype(jnp.float32)
                    * in_range_new
                    * (jnp.abs(ang_new) < (np.pi / 2.0)).astype(jnp.float32)
                )
                pang[m], ang[m] = ang[m], ang_new
                pdist[m], dist[m] = dist[m], dist_new
            for m in M:
                hp[m] = hp[m] - dph * hit_new[1 - m]
            hit = hit_new

            # ---- collisions / bounds (ma_fixedwing_dogfight.py:320-331)
            p0, p1 = d[0]["pos"], d[1]["pos"]
            dx, dy, dz = (p0[k] - p1[k] for k in range(3))
            mutual = (dx * dx + dy * dy + dz * dz < crad2).astype(jnp.float32)
            for m in M:
                v = d[m]["view"]
                coll = jnp.maximum(c[m], mutual)
                lp2 = v[9] * v[9] + v[10] * v[10] + v[11] * v[11]
                oob = (lp2 > dome2).astype(jnp.float32)
                r_step[m] = r_step[m] - 3000.0 * oob - 3000.0 * coll
                term[m] = jnp.minimum(term[m] + coll + oob + othd[m], 1.0)
                trunc[m] = jnp.minimum(trunc[m] + trunc_hit[m], 1.0)
                rwd[m] = rwd[m] + r_step[m]
                collf[m] = jnp.minimum(collf[m] + coll, 1.0)
                oobf[m] = jnp.minimum(oobf[m] + oob, 1.0)
            L = locals()
            return {n: L[n] for n in _CARRY}

        L = locals()
        C = pmk.fori(inner, aviary_step, {n: L[n] for n in _CARRY})
        (d, hp, ang, pang, hit, dist, pdist, term, trunc, rwd, collf,
         oobf) = (C[n] for n in _CARRY)

        # ---- pack back
        out = [None] * ROWS
        for m in M:
            o, dm = m * DR, d[m]
            for i in range(3):
                out[o + pfw._POS + i] = dm["pos"][i]
                out[o + pfw._LVEL + i] = dm["lvel"][i]
                out[o + pfw._AVEL + i] = dm["avel"][i]
            for i in range(4):
                out[o + pfw._QUAT + i] = dm["quat"][i]
            for i in range(12):
                out[o + pfw._VIEW + i] = dm["view"][i]
            for i in range(15):
                out[o + pfw._SLV + i] = dm["slv"][i]
            for i in range(5):
                out[o + pfw._ACT + i] = dm["act"][i]
            out[o + pfw._THR] = dm["thr"]
            for i in range(6):
                out[o + pfw._SP + i] = dm["sp"][i]
            out[o + pfw._CON] = dm["contact"]
            out[o + _HP] = hp[m]
            out[o + _ANG] = ang[m]
            out[o + _PANG] = pang[m]
            out[o + _HIT] = hit[m]
            out[o + _DIST] = dist[m]
            out[o + _PDIST] = pdist[m]
            out[o + _TERM] = term[m]
            out[o + _TRUNC] = trunc[m]
            out[o + _RWD] = rwd[m]
            out[o + _COLLF] = collf[m]
            out[o + _OOBF] = oobf[m]
            out[o + _OTHD] = othd[m]
            out[o + _STEPC] = stepc[m] + 1.0
        return out

    return kernel


def packed_dogfight_step(
    packed: Array,
    seed: Array,
    params: fixedwing.FixedwingParams,
    cfg: fixedwing.FixedwingConfig,
    noisy: bool,
    inner_steps: int,
    dome: float,
    max_steps: int,
    lethal_angle: float,
    lethal_distance: float,
    damage_per_hit: float,
    collision_radius: float,
    sparse: bool = False,
) -> Array:
    """One FULL dogfight agent step on the packed (ROWS, 8, N/8) arena state
    (N arenas = 2N agents; drone m's bank in rows [m * DR, (m + 1) * DR)).
    ``params`` must be CONCRETE; wrap the caller in ``jax.jit``. See
    envs/packed_dogfight.py for the env wrapper."""
    kernel = _build_kernel(
        params, cfg, noisy,
        fuse=dict(
            inner_steps=inner_steps, dome=dome, max_steps=max_steps,
            lethal_angle=lethal_angle, lethal_distance=lethal_distance,
            damage_per_hit=damage_per_hit, collision_radius=collision_radius,
            sparse=sparse,
        ),
    )
    return pmk.grid_call(kernel, packed, seed)
