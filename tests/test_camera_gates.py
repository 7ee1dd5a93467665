"""Camera renderer + Gates env tests
(reference: PyFlyt/core/abstractions/camera.py, gym_envs/quadx_envs/
quadx_gates_env.py; image-shape contract from tests/test_core.py:95-137)."""

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.core import camera as cam
from pyflyt_tpu.envs.quadx_gates import QuadXGatesEnv


def test_render_shapes_and_types():
    """rgba 4ch uint8, depth 1ch float, seg 1ch int (test_core.py:95-137)."""
    boxes = cam.Boxes(
        centers=jnp.asarray([[3.0, 0.0, 1.0]]),
        half_extents=jnp.asarray([[0.5, 0.5, 0.5]]),
        rotations=jnp.eye(3)[None],
        colors=jnp.asarray([[1.0, 0.0, 0.0, 1.0]]),
        visible=jnp.ones((1,), bool),
    )
    rgba, depth, seg = jax.jit(
        lambda p, e: cam.capture_image(p, e, boxes, resolution=(64, 64))
    )(jnp.asarray([0.0, 0.0, 1.0]), jnp.zeros(3))
    assert rgba.shape == (64, 64, 4) and rgba.dtype == jnp.uint8
    assert depth.shape == (64, 64)
    assert seg.shape == (64, 64) and seg.dtype == jnp.int32


def test_render_sees_box_ahead():
    """A red box straight ahead paints the image center red; sky above."""
    boxes = cam.Boxes(
        centers=jnp.asarray([[3.0, 0.0, 1.0]]),
        half_extents=jnp.asarray([[0.5, 0.5, 0.5]]),
        rotations=jnp.eye(3)[None],
        colors=jnp.asarray([[1.0, 0.0, 0.0, 1.0]]),
        visible=jnp.ones((1,), bool),
    )
    rgba, depth, seg = cam.capture_image(
        jnp.asarray([0.0, 0.0, 1.0]), jnp.zeros(3), boxes, resolution=(65, 65)
    )
    center = np.asarray(rgba[32, 32])
    assert center[0] == 255 and center[1] == 0  # red
    assert int(seg[32, 32]) == 1  # box index 0 -> seg 1
    assert int(seg[0, 32]) == -1  # sky at top
    assert int(seg[64, 32]) == 0  # ground at bottom
    # depth of box (t=2.5) < depth of sky (1.0)
    assert float(depth[32, 32]) < 1.0


def test_render_yaw_turns_view():
    """Yawing 180° puts the box behind: center becomes sky/ground."""
    boxes = cam.Boxes(
        centers=jnp.asarray([[3.0, 0.0, 1.0]]),
        half_extents=jnp.asarray([[0.5, 0.5, 0.5]]),
        rotations=jnp.eye(3)[None],
        colors=jnp.asarray([[1.0, 0.0, 0.0, 1.0]]),
        visible=jnp.ones((1,), bool),
    )
    rgba, _, seg = cam.capture_image(
        jnp.asarray([0.0, 0.0, 1.0]),
        jnp.asarray([0.0, 0.0, float(np.pi)]),
        boxes,
        resolution=(65, 65),
    )
    assert int(seg[32, 32]) != 1


def test_gate_boxes_frame():
    """4 segments forming a square opening around the gate center."""
    boxes = cam.gate_boxes_segments(
        jnp.asarray([[0.0, 0.0, 1.0]]),
        jnp.zeros((1, 3)),
        jnp.asarray([[0.0, 1.0, 0.0, 1.0]]),
    )
    c = np.asarray(boxes.centers)
    assert c.shape == (4, 3)
    np.testing.assert_allclose(
        sorted(c[:, 2]), [0.775, 1.0, 1.0, 1.225], atol=1e-6
    )


def test_gate_frame_csg_parity():
    """gate_boxes (one holed box per gate) renders pixel-identically to the
    brute-force 4-bar union (gate_boxes_segments) from random viewpoints —
    same colors, same depth, same per-GATE segmentation."""
    key = jax.random.PRNGKey(7)
    k_pos, k_ang, k_eye, k_look = jax.random.split(key, 4)
    g = 4
    positions = jax.random.uniform(k_pos, (g, 3), minval=-3.0, maxval=3.0)
    positions = positions.at[:, 2].add(4.0)
    eulers = jax.random.uniform(k_ang, (g, 3), minval=-1.2, maxval=1.2)
    colors = jnp.eye(4)[jnp.arange(g) % 4] * 0.8 + 0.2
    holed = cam.gate_boxes(positions, eulers, colors)
    bars = cam.gate_boxes_segments(positions, eulers, colors)
    for i in range(6):
        eye = jax.random.uniform(
            jax.random.fold_in(k_eye, i), (3,), minval=-6.0, maxval=6.0
        ).at[2].add(7.0)
        euler = jax.random.uniform(
            jax.random.fold_in(k_look, i), (3,), minval=-1.0, maxval=1.0
        )
        rgba_h, depth_h, seg_h = cam.capture_image(
            eye, euler, holed, resolution=(48, 48)
        )
        rgba_b, depth_b, seg_b = cam.capture_image(
            eye, euler, bars, resolution=(48, 48)
        )
        np.testing.assert_array_equal(np.asarray(rgba_h), np.asarray(rgba_b))
        np.testing.assert_allclose(
            np.asarray(depth_h), np.asarray(depth_b), atol=1e-5
        )
        # bar index 4·gate+bar → gate index (ground 0 / sky −1 unchanged)
        seg_b = np.asarray(seg_b)
        seg_gate = np.where(seg_b > 0, (seg_b - 1) // 4 + 1, seg_b)
        np.testing.assert_array_equal(np.asarray(seg_h), seg_gate)


# ---------------------------------------------------------------------------
# gates env
# ---------------------------------------------------------------------------

ENV = QuadXGatesEnv(camera_resolution=(32, 32))


def test_gates_reset_obs():
    state, obs = ENV.reset(jax.random.PRNGKey(0))
    assert obs["attitude"].shape == (21,)
    assert obs["rgba_cam"].shape == (4, 32, 32)
    assert obs["rgba_cam"].dtype == jnp.uint8
    assert obs["target_deltas"].shape == (5, 3)
    # chained gates: consecutive spacings within [min, max·(1+slack)]
    g = np.asarray(state.gate_positions)
    legs = np.linalg.norm(np.diff(np.vstack([[0, 0, 1], g]), axis=0), axis=-1)
    assert (legs >= 1.0 - 1e-5).all() and (legs <= 4.0 + 2.0).all()


def test_gates_pass_gives_100():
    state, obs = ENV.reset(jax.random.PRNGKey(1))
    # teleport the current gate onto the drone hover point
    gp = state.gate_positions.at[0].set(jnp.asarray([0.0, 0.0, 1.0]))
    state = state.replace(gate_positions=gp)
    step = jax.jit(ENV.step)
    state, out = step(state, jnp.zeros(4))
    assert float(out.reward) > 90.0
    assert int(state.idx) == 1
    assert int(out.info["num_targets_reached"]) == 1


def test_gates_too_far_terminates():
    env = QuadXGatesEnv(camera_resolution=(32, 32), flight_mode=7)
    state, obs = env.reset(jax.random.PRNGKey(2))
    # teleport all gates far away -> dis > 2·max_gate_distance
    gp = state.gate_positions + 100.0
    state = state.replace(gate_positions=gp)
    state, out = jax.jit(env.step)(state, jnp.asarray([0.0, 0.0, 0.0, 1.0]))
    assert bool(out.termination)
    assert bool(out.info["out_of_bounds"])
    assert float(out.reward) <= -100.0


def test_gates_determinism():
    step = jax.jit(ENV.step)

    def rollout(seed):
        state, obs = ENV.reset(jax.random.PRNGKey(seed))
        rows = [np.asarray(obs["rgba_cam"])]
        for _ in range(5):
            state, out = step(state, jnp.asarray([0.0, 0.0, 0.0, 0.4]))
            rows.append(np.asarray(out.obs["rgba_cam"]))
        return rows

    for a, b in zip(rollout(3), rollout(3)):
        np.testing.assert_array_equal(a, b)


def test_gates_camera_sees_green_gate():
    """The current gate is green in the FPV image for a drone looking at it
    (128² so the 5 cm frame bars span ≥1 pixel at 2 m)."""
    env = QuadXGatesEnv(camera_resolution=(128, 128))
    state, obs = env.reset(jax.random.PRNGKey(4))
    # put gate 0 straight ahead of the (level) drone
    gp = state.gate_positions.at[0].set(jnp.asarray([2.0, 0.0, 1.0]))
    ge = state.gate_eulers.at[0].set(jnp.asarray([0.0, 0.0, jnp.pi / 2]))
    state = state.replace(gate_positions=gp, gate_eulers=ge)
    img = np.asarray(env._render_camera(state))  # (4, H, W)
    # some pixels must be pure green (the gate frame)
    green = (img[0] < 50) & (img[1] > 200) & (img[2] < 50)
    assert green.sum() > 3


def test_gym_rgb_array_render():
    """render() returns HxWx4 uint8 for every registered env
    (the reference contract — tests/test_gym_envs.py:174-196)."""
    import gymnasium

    from pyflyt_tpu.envs.gym_wrapper import register_envs

    register_envs()
    for env_id in (
        "PyFlyt/QuadX-Hover-v1",
        "PyFlyt/QuadX-Waypoints-v1",
        # gates: its scene_boxes carries rot_index-deduplicated rotations —
        # regression check for the concat_boxes merge (camera.concat_boxes)
        "PyFlyt/QuadX-Gates-v1",
        "PyFlyt/Fixedwing-Waypoints-v1",
        "PyFlyt/Rocket-Landing-v1",
    ):
        env = gymnasium.make(env_id, render_mode="rgb_array").unwrapped
        env.reset(seed=0)
        img = env.render()
        assert img.shape == (480, 480, 4), env_id
        assert img.dtype == np.uint8
        env.close()


def test_vision_ppo_trains_on_gates():
    """End-to-end vision RL: PPO with networks.VisionActorCritic consumes
    the Gates env's dict obs (attitude + rgba_cam + target_deltas) through
    the standard _flat_obs path — finite losses, params move."""
    from pyflyt_tpu.rl.networks import VisionActorCritic
    from pyflyt_tpu.rl.ppo import PPO, PPOConfig

    env = QuadXGatesEnv(camera_resolution=(16, 16), num_targets=3)
    cfg = PPOConfig(
        num_envs=4, rollout_steps=8, num_epochs=1, num_minibatches=2,
        learning_rate=3e-4, init_log_std=-0.5,
    )
    net = VisionActorCritic(
        action_dim=4,
        image_offset=env.combined_size,
        image_shape=(4, 16, 16),
        conv_features=(8, 16),
        feature_sizes=(32,),
        init_log_std=-0.5,
    )
    ppo = PPO(env, cfg, network=net)
    runner = ppo.init(jax.random.PRNGKey(0))
    it = jax.jit(ppo.train_iteration)
    before = jax.tree.leaves(runner.params)[0].copy()
    for _ in range(2):
        runner, m = it(runner)
        assert np.isfinite(float(m["loss"]))
    after = jax.tree.leaves(runner.params)[0]
    assert not np.allclose(np.asarray(before), np.asarray(after))


def test_vision_net_fused_paths_guarded():
    """A custom network is used as given (there is no MLP-only fused path
    left to guard against), and PPOConfig has no fused-kernel options."""
    import pytest

    from pyflyt_tpu.rl.networks import VisionActorCritic
    from pyflyt_tpu.rl.ppo import PPO, PPOConfig

    env = QuadXGatesEnv(camera_resolution=(16, 16), num_targets=3)
    net = VisionActorCritic(
        action_dim=4, image_offset=env.combined_size, image_shape=(4, 16, 16)
    )
    assert PPO(env, PPOConfig(), network=net).network is net
    with pytest.raises(TypeError):
        PPOConfig(fused_sgd=True)


def test_cached_reset_dict_obs_donation_safe():
    """Dict-obs envs return state fields directly in obs, so the cached
    auto-reset pool used to hold the SAME buffer at two runner leaves —
    breaking rl/train.py's donated jit with "attempt to donate the same
    buffer twice". envs.base._unalias must keep cache_obs buffer-distinct
    both at init and across the in-jit refresh."""
    from pyflyt_tpu.rl.networks import VisionActorCritic
    from pyflyt_tpu.rl.ppo import PPO, PPOConfig

    env = QuadXGatesEnv(camera_resolution=(8, 8), num_targets=3)
    net = VisionActorCritic(
        action_dim=4, image_offset=env.combined_size, image_shape=(4, 8, 8),
        conv_features=(8,), feature_sizes=(16,),
    )
    cfg = PPOConfig(num_envs=4, rollout_steps=4, num_epochs=1,
                    num_minibatches=2, cached_reset_refresh=2)
    ppo = PPO(env, cfg, network=net)
    runner = ppo.init(jax.random.PRNGKey(0))
    it = jax.jit(ppo.train_iteration, donate_argnums=(0,))
    for _ in range(3):  # crosses a refresh boundary (refresh period 2)
        runner, m = it(runner)
    assert np.isfinite(float(m["loss"]))


def _im2col_conv(p, x):
    """Reference stride-2 SAME 3x3 conv as patches @ kernel matrix."""
    cin, f = p["kernel"].shape[2], p["kernel"].shape[3]
    patches = jax.lax.conv_general_dilated_patches(
        x, (3, 3), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )  # (B, oh, ow, Cin*9), channel-major (c, kh, kw)
    kmat = p["kernel"].transpose(2, 0, 1, 3).reshape(cin * 9, f)
    return jnp.matmul(patches, kmat, precision="highest") + p["bias"]


def test_vision_conv_impls_exact_parity():
    """The vision net's conv encoder equals the same math written as
    im2col matmuls, with the Conv_i/{kernel,bias} tree archived
    checkpoints carry (rl/networks._strided_conv)."""
    from pyflyt_tpu.rl.networks import VisionActorCritic

    net = VisionActorCritic(
        action_dim=4, image_offset=10, image_shape=(4, 16, 16),
        conv_features=(8, 16), feature_sizes=(16,),
    )
    obs = jax.random.uniform(
        jax.random.PRNGKey(0), (5, 10 + 4 * 16 * 16 + 6),
        minval=0.0, maxval=255.0,
    )
    params = net.init(jax.random.PRNGKey(1), obs)
    p = params["params"]
    assert "Conv_0" in p and "kernel" in p["Conv_0"]
    ref = net.apply(params, obs)

    x, vec = net._split(obs)
    for i in range(2):
        x = jax.nn.relu(_im2col_conv(p[f"Conv_{i}"], x))
    feat = jnp.concatenate([x.reshape(5, -1), vec], axis=-1)
    got = net.apply_heads(p, feat)
    for a, b, nm in zip(ref, got, ("mean", "log_std", "value")):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=nm,
        )


def test_strided_conv_impls_odd_sizes():
    """The stride-2 SAME conv matches the im2col reference for ODD spatial
    extents too (asymmetric SAME padding), with ceil(h/2) outputs."""
    from pyflyt_tpu.rl.networks import _conv_init, _strided_conv

    for h in (7, 9, 17, 33):
        x = jax.random.normal(jax.random.PRNGKey(0), (3, h, h, 5))
        p = _conv_init(jax.random.PRNGKey(1), 5, 6)
        got = _strided_conv(p, x, jnp.float32)
        assert got.shape == (3, -(-h // 2), -(-h // 2), 6)
        np.testing.assert_allclose(
            np.asarray(_im2col_conv(p, x)), np.asarray(got),
            rtol=2e-5, atol=2e-5, err_msg=f"h={h}",
        )


def test_vision_net_rank_generic():
    """The NCHW->NHWC move must be rank-independent (advisor r4, low):
    a doubly-batched observation must produce the same outputs as the
    flattened single-batch apply."""
    from pyflyt_tpu.rl.networks import VisionActorCritic

    net = VisionActorCritic(
        action_dim=4, image_offset=10, image_shape=(4, 8, 8),
        conv_features=(8,), feature_sizes=(16,),
    )
    obs_size = 10 + 4 * 8 * 8 + 6  # vec prefix + NCHW image + vec suffix
    obs = jax.random.uniform(
        jax.random.PRNGKey(0), (2, 3, obs_size), minval=0.0, maxval=255.0
    )
    params = net.init(jax.random.PRNGKey(1), obs.reshape(6, -1))
    m_flat, s_flat, v_flat = net.apply(params, obs.reshape(6, -1))
    m_2d, s_2d, v_2d = net.apply(params, obs)
    # tolerance: XLA batches the conv differently for (6,...) vs (2,3,...)
    # leading dims — behavioral (axis-order) equivalence is what's tested
    np.testing.assert_allclose(
        np.asarray(m_2d.reshape(6, -1)), np.asarray(m_flat),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(v_2d.reshape(6)), np.asarray(v_flat),
        rtol=1e-4, atol=1e-5,
    )


def test_tracking_camera():
    """is_tracking_camera parity (reference camera.py:86,105-137): the eye
    is displaced by the link-frame offset and the view re-aims at the
    vehicle link position instead of out to infinity."""
    from pyflyt_tpu.core import camera as cam
    from pyflyt_tpu.core import math as pm

    pos = jnp.asarray([1.0, 2.0, 3.0])
    euler = jnp.asarray([0.1, -0.2, 0.7])
    offset = jnp.asarray([-2.0, 0.0, 1.0])

    # eye = link pos + R_link @ offset (camera.py:105-112)
    eye_expect = np.asarray(pos + pm.euler_to_rotmat(euler) @ offset)
    origin, dirs = cam.camera_rays_tracking(
        jnp.asarray(eye_expect), pos,
        pm.euler_to_rotmat(euler)[:, 2], (65, 65), 90.0,
    )
    np.testing.assert_allclose(np.asarray(origin), eye_expect, atol=1e-6)
    # the central ray points from eye at the link position
    center = np.asarray(dirs[32, 32])
    want = np.asarray(pos) - eye_expect
    want /= np.linalg.norm(want)
    np.testing.assert_allclose(center, want, atol=1e-5)
    # rays are unit length and the basis is orthonormal (no roll skew):
    # every ray on the central column stays in the forward/up plane
    np.testing.assert_allclose(
        np.asarray(jnp.linalg.norm(dirs, axis=-1)), 1.0, atol=1e-5
    )

    # end-to-end: a box at the link position lands in the image center
    boxes = cam.Boxes(
        centers=pos[None, :],
        half_extents=jnp.asarray([[0.3, 0.3, 0.3]]),
        rotations=jnp.eye(3)[None],
        colors=jnp.asarray([[0.0, 0.0, 1.0, 1.0]]),
        visible=jnp.ones((1,), bool),
    )
    rgba, _, seg = cam.capture_image(
        pos, euler, boxes, resolution=(65, 65), fov_degrees=90.0,
        position_offset=offset, is_tracking=True,
    )
    assert int(seg[32, 32]) == 1  # box id 1 at the exact center
    # without tracking, the same view axis misses the vehicle
    _, _, seg_fpv = cam.capture_image(
        pos, euler, boxes, resolution=(65, 65), fov_degrees=90.0,
        position_offset=offset, is_tracking=False,
    )
    assert int(seg_fpv[32, 32]) != 1
