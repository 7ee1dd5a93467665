"""Spawn scene objects — an OBJ mesh and a raw box — and detect contact.

Batched-JAX equivalent of /root/reference/examples/core/06_spawning_objects.py:
the reference loads a duck OBJ into PyBullet (obj_visual + obj_collision +
loadOBJ + register_all_new_bodies, core/utils/load_objs.py:8-80); here one
``loadOBJ`` call decomposes the mesh into static oriented boxes
(``pyflyt_tpu.core.load_objs``) — the same geometry the vision envs render
and the Aviary collides against (sphere-vs-OBB, with an optional impulse
response instead of detect-only termination).
"""

import os

import jax
import jax.numpy as jnp

from pyflyt_tpu.core import Aviary, DroneSpec, loadOBJ, merge_boxes
from pyflyt_tpu.core.camera import Boxes

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")

# the duck, sitting on the ground in the drone's path (the reference drops
# it from z=10 with baseMass=1; scene bodies here are static, so it starts
# where it would land)
duck = loadOBJ(
    os.path.join(ASSETS, "duck.obj"),
    mesh_scale=(2.0, 2.0, 2.0),
    base_position=(2.0, 0.0, 0.0),
    base_orientation=(0.0, 0.0, 1.2),
    color=(1.0, 0.85, 0.1, 1.0),
)

# scenes compose: add a plain 1 m box further along
box = Boxes(
    centers=jnp.asarray([[4.0, 0.0, 1.0]]),
    half_extents=jnp.asarray([[0.5, 0.5, 0.5]]),
    rotations=jnp.eye(3)[None],
    colors=jnp.asarray([[0.6, 0.6, 0.9, 1.0]]),
    visible=jnp.ones((1,), bool),
)
scene = merge_boxes(duck, box)

aviary = Aviary(
    start_pos=[[0.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=7),),
    obstacles=scene,
)

state = aviary.reset(jax.random.PRNGKey(0))
state = aviary.set_setpoint(state, 0, jnp.asarray([2.0, 0.0, 0.0, 1.0]))  # into the duck

step = jax.jit(aviary.step)
for i in range(600):
    state = step(state)
    if bool(state.contact[0]):
        print(f"contact with the duck at aviary step {i}, "
              f"pos={aviary.state(state, 0)[3]}")
        break
else:
    print("no contact (unexpected)")
