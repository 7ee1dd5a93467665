"""Shared helpers for the fused vehicle kernels (Pallas, Triton route).

Every vehicle kernel launches through ``grid_call``: one program owns a
``(rows, 8, tile)`` block of the folded ``(rows, 8, N/8)`` state, which is one
env per thread at the default tile. Rows are loaded and stored one at a time
(``(8, tile)`` each), because the Triton lowering only takes values whose size
is a power of two. Noise comes from a counter-based hash of (seed, global env
index, draw index), so noisy kernels run the same in interpret mode.

The quaternion helpers mirror pyflyt_tpu/core/math.py on unpacked per-row
values instead of stacked (..., 4) arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu import device

SUBLANES = 8  # the env axis is folded (N,) -> (8, N/8)
TILE = 16  # lanes per program: 8 x 16 = 128 envs, one per thread
NUM_WARPS = 4


def asin(s):
    return jnp.arcsin(jnp.clip(s, -1.0, 1.0))


def quat_rotmat(quat):
    """[x, y, z, w] registers -> 9 rotation-matrix entries (body->world),
    row-major (r00, r01, r02, r10, ..., r22)."""
    x, y, z, w = quat
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_euler(quat):
    """[x, y, z, w] -> (roll, pitch, yaw), PyBullet extraction
    (core/math.py::quat_to_euler)."""
    x, y, z, w = quat
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = asin(2 * (w * y - z * x))
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_integrate(quat, avel, dt):
    """Exact exponential-map quaternion step under world angular velocity
    (core/math.py::quat_integrate) on register values."""
    x, y, z, w = quat
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
    return [nx * norm, ny * norm, nz * norm, nw * norm]


def _mix32(h):
    """lowbias32 integer finaliser (uint32 -> uint32, a bijection)."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    return h ^ (h >> 16)


def hash_uniform(seed, env, draw: int):
    """Uniform (0, 1) f32 from (seed, env index, draw index); ``env`` is a
    uint32 array, ``seed`` a uint32 scalar, ``draw`` a trace-time int."""
    key = _mix32(seed + jnp.uint32((0x9E3779B9 * (draw + 1)) & 0xFFFFFFFF))
    h = _mix32(_mix32(env ^ key) + key)
    top = (h >> 8).astype(jnp.int32).astype(jnp.float32)  # 24 bits
    return (top + 0.5) * (1.0 / 16777216.0)


class HashNormal:
    """Standard normals for one kernel program, one per env per draw.

    Draw ``k`` of env ``e`` is a pure function of (seed, e, k): Box-Muller on
    two hashed uniforms. Each call to ``normal()`` is a new draw index."""

    def __init__(self, seed, env):
        self.seed = seed
        self.env = env
        self.draws = 0

    def child(self, i):
        """An independent stream for loop iteration ``i`` (traced or int):
        a loop body is traced once, so its draws are indexed by the loop
        counter through the seed."""
        step = jnp.asarray(i).astype(jnp.uint32) + jnp.uint32(1)
        seed = _mix32(self.seed ^ _mix32(step * jnp.uint32(0x85EBCA77)))
        return HashNormal(seed, self.env)

    def normal(self):
        k = self.draws
        self.draws += 1
        u1 = hash_uniform(self.seed, self.env, 2 * k)
        u2 = hash_uniform(self.seed, self.env, 2 * k + 1)
        return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos((2.0 * np.pi) * u2)


# ---------------------------------------------------------------------------
# constant-vector algebra with trace-time zero skipping
# ---------------------------------------------------------------------------
# Kernel parameters (unit vectors, lever arms) are concrete at bake time and
# usually sparse (axis-aligned units, in-plane offsets). These helpers expand
# dot/cross/axpy against a concrete numpy 3-vector, skipping exact-zero terms
# so the kernels carry no multiply-by-zero chains.


def dot_const(v, c):
    """dot(v, c) for register 3-list v and concrete 3-vector c."""
    acc = None
    for i in range(3):
        ci = float(c[i])
        if ci == 0.0:
            continue
        term = v[i] if ci == 1.0 else v[i] * ci
        acc = term if acc is None else acc + term
    if acc is None:
        return jnp.zeros_like(v[0])
    return acc


def add_scaled(acc, s, c):
    """acc[i] += s * c[i] for concrete 3-vector c (in place on the list)."""
    for i in range(3):
        ci = float(c[i])
        if ci == 0.0:
            continue
        acc[i] = acc[i] + (s if ci == 1.0 else s * ci)
    return acc


def cross_const_vec(c, v):
    """cross(c, v) for concrete 3-vector c and register 3-list v."""
    cx, cy, cz = (float(c[0]), float(c[1]), float(c[2]))

    def term(a, p, b, q):
        # a*p - b*q with zero skipping
        left = None if a == 0.0 else (p if a == 1.0 else p * a)
        right = None if b == 0.0 else (q if b == 1.0 else q * b)
        if left is None and right is None:
            return jnp.zeros_like(v[0])
        if left is None:
            return -right
        if right is None:
            return left
        return left - right

    return [
        term(cy, v[2], cz, v[1]),
        term(cz, v[0], cx, v[2]),
        term(cx, v[1], cy, v[0]),
    ]


def matvec_const(M, v):
    """M @ v for concrete 3x3 numpy M and register 3-list v (zero-skipped)."""
    return [dot_const(v, M[i]) for i in range(3)]


def matvec_t_const(M, v):
    """M.T @ v for concrete 3x3 numpy M and register 3-list v."""
    return [dot_const(v, M[:, i]) for i in range(3)]


def fori(n: int, body, state):
    """``state = body(i, state)`` for ``i`` in ``range(n)`` as ONE loop in the
    kernel: the body is traced and compiled once, not unrolled ``n`` times
    (the compile time of the Triton route grows steeply with kernel length).
    ``state`` is any pytree of ``(8, tile)`` values."""
    if n == 1:
        return body(0, state)
    return jax.lax.fori_loop(0, n, body, state)


def _pow2_divisor(lanes: int, tile: int) -> int:
    """Largest power of two <= tile that divides lanes."""
    t = 1
    while t * 2 <= tile and lanes % (t * 2) == 0:
        t *= 2
    return t


def grid_call(kernel, packed, seed, tile: int = TILE):
    """Launches ``kernel`` over the folded ``(rows, 8, N/8)`` state.

    ``kernel(S, rng)`` reads input row ``r`` as ``S[r]`` (an ``(8, tile)``
    value), draws noise with ``rng.normal()``, and returns the list of output
    rows (``None`` rows are written as zeros). One program per ``tile`` lanes;
    the seed travels as a ``(1,)`` int32 operand."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    rows, sublanes, lanes = packed.shape
    tile = _pow2_divisor(lanes, tile)
    grid = (lanes // tile,)

    def body(seed_ref, s_ref, o_ref):
        cache = {}

        class Rows:
            def __getitem__(self, r):
                if r not in cache:
                    cache[r] = s_ref[r]
                return cache[r]

        pid = pl.program_id(0)
        sub = jax.lax.broadcasted_iota(jnp.int32, (sublanes, tile), 0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (sublanes, tile), 1)
        env = (sub * lanes + pid * tile + lane).astype(jnp.uint32)
        rng = HashNormal(seed_ref[0].astype(jnp.uint32), env)
        out = kernel(Rows(), rng)
        assert len(out) == rows, (len(out), rows)
        zero = jnp.zeros((sublanes, tile), packed.dtype)
        for r, v in enumerate(out):
            o_ref[r] = zero if v is None else v

    block = pl.BlockSpec((rows, sublanes, tile), lambda i: (0, 0, i))
    return pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct(packed.shape, packed.dtype),
        grid=grid,
        in_specs=[pl.BlockSpec((1,), lambda i: (0,)), block],
        out_specs=block,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=device.pallas_interpret(),
    )(jnp.reshape(seed, (1,)).astype(jnp.int32), packed)


def waypoint_track(R, lp, tgt, rem, ndist, NT, goal):
    """Register-level waypoint tracking shared by the quadx and fixedwing
    fused kernels (envs/utils/waypoints.py semantics on the cyclically
    rolled in-kernel target layout; see ops/pallas_fixedwing.py's row
    docs). ``R`` is the flattened pre-integration rotation (9 registers),
    ``lp`` the lagged position (3), ``tgt`` 12 rolled target rows, ``rem``
    the remaining count, ``ndist`` the previous new-distance memo.

    Returns ``(tgt_c, rem_c, ndist_new, odist_c, progress, tdlt_c,
    reached, all_reached)`` — the caller applies its env's reward shaping
    (the proximity coefficient differs per env) and bookkeeping.
    """
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
    # update_distances: world->body deltas for every (rolled) target
    deltas = []
    for k in range(NT):
        dxk = tgt[3 * k] - lp[0]
        dyk = tgt[3 * k + 1] - lp[1]
        dzk = tgt[3 * k + 2] - lp[2]
        deltas.append([
            r00 * dxk + r10 * dyk + r20 * dzk,
            r01 * dxk + r11 * dyk + r21 * dzk,
            r02 * dxk + r12 * dyk + r22 * dzk,
        ])
    d0 = deltas[0]
    ndist_new = jnp.sqrt(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2])
    odist_c = ndist  # old <- previous new
    progress = odist_c - ndist_new

    # target_deltas obs: pre-advance, rows >= remaining zeroed
    # (envs/utils/waypoints.py remaining_deltas)
    tdlt_c = []
    for k in range(NT):
        keep_k = (rem > (k + 0.5)).astype(jnp.float32)
        tdlt_c += [deltas[k][i] * keep_k for i in range(3)]
    tdlt_c += [jnp.zeros_like(rem)] * (12 - 3 * NT)

    reached = ((ndist_new < goal) & (rem > 0.5)).astype(jnp.float32)
    # advance: cyclic roll so the next target lands on row 0
    tgt_c = [
        jnp.where(
            reached > 0.0,
            tgt[(3 * (k + 1) + i) % (3 * NT)],
            tgt[3 * k + i],
        )
        for k in range(NT)
        for i in range(3)
    ] + tgt[3 * NT :]
    rem_c = rem - reached
    all_reached = (rem_c < 0.5).astype(jnp.float32)
    return (
        tgt_c, rem_c, ndist_new, odist_c, progress, tdlt_c, reached,
        all_reached,
    )
