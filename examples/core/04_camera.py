"""Capture a drone camera image (RGBA / depth / segmentation).

Batched-JAX equivalent of /root/reference/examples/core/04_camera.py: the
reference reads ``drone.rgbaImg/depthImg/segImg`` off a PyBullet GL camera;
here ``capture_image`` is an analytic ray-cast render — fully jittable, so
vision observations batch with ``vmap`` like everything else.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.core import Aviary, DroneSpec
from pyflyt_tpu.core.camera import capture_image, gate_boxes

# a couple of race gates in front of the drone to look at
boxes = gate_boxes(
    gate_positions=jnp.asarray([[3.0, 0.0, 1.0], [6.0, 1.5, 1.5]]),
    gate_eulers=jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.5]]),
    colors=jnp.asarray([[1.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]]),
)

aviary = Aviary(
    start_pos=[[0.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=6),),  # velocity control
    obstacles=boxes,
)
state = aviary.reset(jax.random.PRNGKey(0))
for _ in range(100):
    state = jax.jit(aviary.step)(state)

view = aviary.state(state, 0)
rgba, depth, seg = jax.jit(
    lambda pos, euler: capture_image(
        pos, euler, boxes, resolution=(128, 128), fov_degrees=90.0,
        camera_angle_degrees=20.0,
    )
)(view[3], view[1])

print("rgba", rgba.shape, rgba.dtype, " depth", depth.shape,
      " seg ids:", np.unique(np.asarray(seg)))

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    axes[0].imshow(np.asarray(rgba)), axes[0].set_title("rgba")
    axes[1].imshow(np.asarray(depth), cmap="gray"), axes[1].set_title("depth")
    axes[2].imshow(np.asarray(seg)), axes[2].set_title("seg")
    fig.savefig("camera.png", dpi=80)
    print("wrote camera.png")
except ImportError:
    pass
