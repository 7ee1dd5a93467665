"""JAX camera: link-attached FPV/gimbal camera with an analytic ray-cast
renderer.

Replaces /root/reference/PyFlyt/core/abstractions/camera.py, whose
``capture_image`` delegates to PyBullet's OpenGL renderer (camera.py:155-178).
Here there is no GL context on the device, so the scene (ground plane + oriented boxes — all
the geometry the reference's vision envs actually contain: race gates, pads,
targets) is rendered by batched ray-box intersection under ``jit``: one fused
XLA program produces the RGBA/depth/segmentation triple for a whole env batch
on device.

View/projection conventions follow the reference: vertical FOV in degrees,
near 0.1 / far 255 (camera.py:73-78), FPV mode pitches the camera by
``camera_angle_degrees`` (camera.py:95-137), depth is the OpenGL-style
nonlinear z-buffer value, segmentation is the per-pixel object index
(−1 = none, 0 = ground, 1+i = box i).
"""

from __future__ import annotations

import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm

NEAR, FAR = 0.1, 255.0  # camera.py:76-77
SKY_RGBA = (178, 204, 255, 255)  # PyBullet-like light sky
GROUND_A = (153, 153, 153, 255)
GROUND_B = (102, 102, 102, 255)


@struct.dataclass
class Boxes:
    """Oriented boxes: the renderable scene objects.

    ``rot_index`` (optional) deduplicates rotations: when set, ``rotations``
    holds (r, 3, 3) UNIQUE rotations and ``rot_index`` maps each of the n
    boxes to one of them. Rotating every ray into every box frame is the
    dominant render cost (9 mul + 6 add per ray·box); scenes built from
    multi-part props sharing one pose — e.g. the 4 bars of
    gate_boxes_segments share ONE rotation — cut that 4× by sharing."""

    centers: Array  # (n, 3)
    half_extents: Array  # (n, 3)
    rotations: Array  # (n, 3, 3) box→world, or (r, 3, 3) with rot_index
    colors: Array  # (n, 4) RGBA in [0, 1]
    visible: Array  # (n,) bool
    rot_index: Array | None = None  # (n,) int32 into rotations, or None
    # (n, 2) local (y, z) half-extents of a rectangular through-hole along
    # the box x-axis, or None. A holed box renders as the exact CSG
    # difference outer-minus-hole-prism — a race gate's 4 bars ARE that
    # solid, so one holed-box test replaces 4 slab tests (see gate_boxes).
    # Entries with hole_half <= 0 are solid.
    hole_half: Array | None = None


def _view_euler(
    euler: Array, camera_angle_degrees: float, use_gimbal: bool
) -> Array:
    """FPV mode tilts the view by ``camera_angle_degrees`` about the body
    pitch axis; gimbal mode locks roll and pitches down by the same angle
    (camera.py:113-121)."""
    if use_gimbal:
        return jnp.stack(
            [
                jnp.zeros_like(euler[..., 0]),
                jnp.full_like(euler[..., 1], -jnp.deg2rad(camera_angle_degrees)),
                euler[..., 2],
            ],
            axis=-1,
        )
    return euler.at[..., 1].add(jnp.deg2rad(camera_angle_degrees))


def _frustum_rays(
    forward: Array,
    left: Array,
    up: Array,
    resolution: tuple[int, int],
    fov_degrees: float,
) -> Array:
    """(H, W, 3) unit ray directions through the image plane of an
    orthonormal FLU camera basis."""
    h, w = resolution
    tan_half = jnp.tan(jnp.deg2rad(fov_degrees) / 2.0)
    aspect = w / h  # camera.py:75
    v = jnp.linspace(1.0, -1.0, h) * tan_half
    u = jnp.linspace(1.0, -1.0, w) * tan_half * aspect  # +u = left
    dirs = (
        forward[None, None, :]
        + u[None, :, None] * left[None, :]
        + v[:, None, None] * up[None, :]
    )
    return dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)


def camera_rays(
    position: Array,
    euler: Array,
    resolution: tuple[int, int],
    fov_degrees: float,
    camera_angle_degrees: float = 0.0,
    use_gimbal: bool = False,
) -> tuple[Array, Array]:
    """(origin (3,), directions (H, W, 3)) for the drone-mounted camera."""
    R = pm.euler_to_rotmat(_view_euler(euler, camera_angle_degrees, use_gimbal))
    dirs = _frustum_rays(
        R[..., :, 0], R[..., :, 1], R[..., :, 2], resolution, fov_degrees
    )
    return position, dirs


def camera_rays_tracking(
    eye: Array,
    target: Array,
    up_hint: Array,
    resolution: tuple[int, int],
    fov_degrees: float,
) -> tuple[Array, Array]:
    """Look-at rays for the tracking camera: the view re-aims from ``eye``
    at ``target`` (the vehicle body) instead of out to infinity, with the
    camera roll set by ``up_hint`` (the reference passes the view rotation's
    up vector into computeViewMatrix — camera.py:124-137)."""
    f = target - eye
    f = f / jnp.maximum(jnp.linalg.norm(f), 1e-9)
    left = jnp.cross(up_hint, f)
    left = left / jnp.maximum(jnp.linalg.norm(left), 1e-9)
    up = jnp.cross(f, left)
    return eye, _frustum_rays(f, left, up, resolution, fov_degrees)


def _ray_box(origin: Array, dirs: Array, boxes: Boxes) -> tuple[Array, Array]:
    """Slab-test every ray against every box.

    Returns (t (H, W, n), hit (H, W, n)).
    """
    # ray in each box frame
    rel = origin - boxes.centers  # (n, 3)
    Rt = jnp.swapaxes(boxes.rotations, -1, -2)  # world→box
    if boxes.rot_index is None:
        o = jnp.einsum("nij,nj->ni", Rt, rel, precision="highest")
        d = jnp.einsum("nij,hwj->hwni", Rt, dirs, precision="highest")
        d = jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
        inv = 1.0 / d
    else:
        # rotate rays AND take reciprocals once per UNIQUE rotation, then
        # fan out per box (the gather fuses into the slab test; both the
        # einsum and the divide shrink n→r: a gate's 4 bars share one
        # rotation, so this is 4× fewer divides)
        d_u = jnp.einsum("rij,hwj->hwri", Rt, dirs, precision="highest")
        d_u = jnp.where(jnp.abs(d_u) < 1e-9, 1e-9, d_u)
        inv = (1.0 / d_u)[:, :, boxes.rot_index, :]
        o = jnp.einsum("nij,nj->ni", Rt[boxes.rot_index], rel, precision="highest")
    t1 = (-boxes.half_extents - o) * inv  # (h, w, n, 3)
    t2 = (boxes.half_extents - o) * inv
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    if boxes.hole_half is None:
        hit = (tmax >= jnp.maximum(tmin, NEAR)) & boxes.visible & (tmin < FAR)
        t = jnp.where(tmin > NEAR, tmin, tmax)
        return jnp.where(hit, t, jnp.inf), hit
    # holed boxes: the ray's solid span is [tmin, tmax] minus the open hole
    # interval (h_lo, h_hi) from the 2D slab test of the through-hole prism
    # (reusing the already-computed reciprocals). Each of the two remaining
    # sub-intervals is resolved with the same entry/exit convention as the
    # solid case, nearest first.
    h1 = (-boxes.hole_half - o[..., 1:]) * inv[..., 1:]
    h2 = (boxes.hole_half - o[..., 1:]) * inv[..., 1:]
    h_lo = jnp.max(jnp.minimum(h1, h2), axis=-1)
    h_hi = jnp.min(jnp.maximum(h1, h2), axis=-1)
    no_hole = jnp.all(boxes.hole_half <= 0.0, axis=-1)  # (n,)
    h_lo = jnp.where(no_hole, jnp.inf, h_lo)
    h_hi = jnp.where(no_hole, -jnp.inf, h_hi)
    ta, tb = tmin, jnp.minimum(tmax, h_lo)  # front solid sub-interval
    ua, ub = jnp.maximum(tmin, h_hi), tmax  # back solid sub-interval
    va = (tb >= jnp.maximum(ta, NEAR)) & (ta < FAR)
    vb = (ub >= jnp.maximum(ua, NEAR)) & (ua < FAR)
    t_a = jnp.where(ta > NEAR, ta, tb)
    t_b = jnp.where(ua > NEAR, ua, ub)
    hit = (va | vb) & boxes.visible
    t = jnp.where(va, t_a, t_b)
    return jnp.where(hit, t, jnp.inf), hit


def render(
    origin: Array,
    dirs: Array,
    boxes: Boxes | None = None,
    ground_z: float = 0.0,
    forward: Array | None = None,
) -> tuple[Array, Array, Array]:
    """Renders (rgba uint8 (H, W, 4), depth float (H, W), seg int32 (H, W)).

    ``forward``: optional (3,) view axis — when given, the depth buffer uses
    eye-space z (``t·(dir·forward)``) like an OpenGL rasterizer, so a flat
    frontal wall has constant depth; without it, depth falls back to ray
    length (larger toward the image edges).
    """
    h, w = dirs.shape[:2]
    t_best = jnp.full((h, w), jnp.inf)
    rgba = jnp.broadcast_to(
        jnp.asarray(SKY_RGBA, jnp.float32) / 255.0, (h, w, 4)
    )
    seg = jnp.full((h, w), -1, jnp.int32)

    # ground plane with a 1 m checkerboard
    dz = jnp.where(jnp.abs(dirs[..., 2]) < 1e-9, 1e-9, dirs[..., 2])
    t_g = (ground_z - origin[2]) / dz
    hit_g = (t_g > NEAR) & (t_g < FAR)
    gx = origin[0] + t_g * dirs[..., 0]
    gy = origin[1] + t_g * dirs[..., 1]
    checker = (jnp.floor(gx) + jnp.floor(gy)) % 2.0 < 1.0
    g_color = jnp.where(
        checker[..., None],
        jnp.asarray(GROUND_A, jnp.float32) / 255.0,
        jnp.asarray(GROUND_B, jnp.float32) / 255.0,
    )
    better = hit_g & (t_g < t_best)
    t_best = jnp.where(better, t_g, t_best)
    rgba = jnp.where(better[..., None], g_color, rgba)
    seg = jnp.where(better, 0, seg)

    if boxes is not None:
        t_all, hit_all = _ray_box(origin, dirs, boxes)
        t_min = jnp.min(t_all, axis=-1)
        idx = jnp.argmin(t_all, axis=-1)
        hit_any = jnp.any(hit_all, axis=-1)
        better = hit_any & (t_min < t_best)
        t_best = jnp.where(better, t_min, t_best)
        rgba = jnp.where(better[..., None], boxes.colors[idx], rgba)
        seg = jnp.where(better, idx + 1, seg)

    # OpenGL-style nonlinear z-buffer (what PyBullet's depthImg contains),
    # over eye-space z when the view axis is known
    z_best = t_best
    if forward is not None:
        z_best = t_best * jnp.einsum("hwi,i->hw", dirs, forward, precision="highest")
    z_clip = jnp.clip(z_best, NEAR, FAR)
    depth = (FAR / (FAR - NEAR)) * (1.0 - NEAR / z_clip)
    depth = jnp.where(jnp.isinf(t_best), 1.0, depth)

    rgba_u8 = (jnp.clip(rgba, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    return rgba_u8, depth, seg


def capture_image(
    position: Array,
    euler: Array,
    boxes: Boxes | None,
    resolution: tuple[int, int] = (128, 128),
    fov_degrees: float = 90.0,
    camera_angle_degrees: float = 0.0,
    use_gimbal: bool = False,
    position_offset: Array | None = None,
    is_tracking: bool = False,
    cinematic: bool = False,
) -> tuple[Array, Array, Array]:
    """Camera.capture_image equivalent: (rgbaImg, depthImg, segImg).

    ``position_offset`` displaces the eye by the LINK-frame offset rotated
    into world coordinates (transposed when ``cinematic`` —
    camera.py:105-112); ``is_tracking`` re-aims the view at the vehicle
    link position instead of out along the view axis (camera.py:86,128-137;
    the reference warns that tracking + gimbal is "funky" — both are
    honored here the same way: the gimbal only shapes the up vector)."""
    eye = position
    if position_offset is not None:
        R_link = pm.euler_to_rotmat(euler)
        R_off = jnp.swapaxes(R_link, -1, -2) if cinematic else R_link
        eye = position + jnp.matmul(
            R_off, jnp.asarray(position_offset), precision="highest"
        )
    if is_tracking:
        R_view = pm.euler_to_rotmat(
            _view_euler(euler, camera_angle_degrees, use_gimbal)
        )
        origin, dirs = camera_rays_tracking(
            eye, position, R_view[..., :, 2], resolution, fov_degrees
        )
    else:
        origin, dirs = camera_rays(
            eye, euler, resolution, fov_degrees, camera_angle_degrees,
            use_gimbal,
        )
    # view axis = central ray (normalized forward after gimbal/FPV tilt)
    h, w = dirs.shape[:2]
    forward = dirs[h // 2, w // 2]
    forward = forward / jnp.linalg.norm(forward)
    return render(origin, dirs, boxes, forward=forward)


def materialize_rotations(boxes: Boxes) -> Boxes:
    """Expands shared rotations to one (3, 3) per box and drops ``rot_index``.

    Boxes built with deduplicated rotations (e.g. ``gate_boxes_segments``) have a
    different pytree structure than plain Boxes, and their indices are only
    valid against their own rotation table — both break naive concatenation.
    Normalizing through this first makes any two Boxes mergeable."""
    if boxes.rot_index is None:
        return boxes
    return boxes.replace(
        rotations=boxes.rotations[boxes.rot_index], rot_index=None
    )


def concat_boxes(*all_boxes: Boxes) -> Boxes:
    """Concatenates Boxes into one scene (gym_wrapper.render merges the
    vehicle body box with the env's ``scene_boxes``). Rotations are
    materialized per box first so mixed rot_index/None inputs are safe."""
    mats = [materialize_rotations(b) for b in all_boxes]
    cat = lambda xs: jnp.concatenate(xs, axis=0)  # noqa: E731
    any_hole = any(b.hole_half is not None for b in mats)
    hole = None
    if any_hole:
        # hole_half <= 0 marks a solid box, so plain boxes merge as zeros
        hole = cat([
            b.hole_half if b.hole_half is not None
            else jnp.zeros((b.centers.shape[0], 2), b.centers.dtype)
            for b in mats
        ])
    return Boxes(
        centers=cat([b.centers for b in mats]),
        half_extents=cat([b.half_extents for b in mats]),
        rotations=cat([b.rotations for b in mats]),
        colors=cat([b.colors for b in mats]),
        visible=cat([b.visible for b in mats]),
        rot_index=None,
        hole_half=hole,
    )


def gate_boxes(
    gate_positions: Array, gate_eulers: Array, colors: Array
) -> Boxes:
    """The race gate frame as ONE holed box per gate.

    The union of the 4 frame bars (gate_boxes_segments) is exactly the
    0.05×0.5×0.5 outer box minus the 0.4×0.4 through-hole, so a single
    holed-box test replaces 4 slab tests — ~3× fewer VPU ops per ray and a
    4× smaller closest-hit reduction in the render hot loop
    (test_gate_frame_csg_parity checks pixel equality against the 4 bars).

    Args:
        gate_positions: (g, 3) gate centers.
        gate_eulers: (g, 3) gate orientations.
        colors: (g, 4) RGBA per gate in [0, 1].

    Returns:
        Boxes with g entries (hole_half set).
    """
    g = gate_positions.shape[0]
    dtype = gate_positions.dtype
    return Boxes(
        centers=gate_positions,
        half_extents=jnp.broadcast_to(
            jnp.asarray([0.025, 0.25, 0.25], dtype), (g, 3)
        ),
        rotations=pm.euler_to_rotmat(gate_eulers),
        colors=colors,
        visible=jnp.ones((g,), bool),
        hole_half=jnp.broadcast_to(jnp.asarray([0.2, 0.2], dtype), (g, 2)),
    )


def gate_boxes_segments(
    gate_positions: Array, gate_eulers: Array, colors: Array
) -> Boxes:
    """The race gate's 4 frame segments as plain oriented boxes
    (race_gate.urdf: bottom/top 0.05×0.5×0.05 at z∓0.225, left/right
    0.05×0.05×0.4 at y∓0.225) — the brute-force ground truth that
    ``gate_boxes``'s holed-box CSG is parity-tested against.
    """
    seg_offsets = jnp.asarray(
        [
            [0.0, 0.0, -0.225],
            [0.0, 0.0, 0.225],
            [0.0, -0.225, 0.0],
            [0.0, 0.225, 0.0],
        ]
    )
    seg_halves = jnp.asarray(
        [
            [0.025, 0.25, 0.025],
            [0.025, 0.25, 0.025],
            [0.025, 0.025, 0.2],
            [0.025, 0.025, 0.2],
        ]
    )
    R = pm.euler_to_rotmat(gate_eulers)  # (g, 3, 3)
    centers = gate_positions[:, None, :] + jnp.einsum(
        "gij,sj->gsi", R, seg_offsets
    , precision="highest")
    g = gate_positions.shape[0]
    return Boxes(
        centers=centers.reshape(g * 4, 3),
        half_extents=jnp.tile(seg_halves, (g, 1)),
        # the 4 segments of a gate share its rotation: store g unique
        # rotations and index them (4× less ray-rotation work in _ray_box)
        rotations=R,
        colors=jnp.repeat(colors, 4, axis=0),
        visible=jnp.ones((g * 4,), bool),
        rot_index=jnp.repeat(jnp.arange(g, dtype=jnp.int32), 4),
    )
