"""Spawn a single QuadX and fly a position setpoint.

Batched-JAX equivalent of /root/reference/examples/core/01_single_drone.py.
"""

import jax
import jax.numpy as jnp

from pyflyt_tpu.core import Aviary, DroneSpec

# the functional Aviary is static config + pure state transitions
aviary = Aviary(
    start_pos=[[0.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=7),),  # mode 7: x, y, yaw, z
)

state = aviary.reset(jax.random.PRNGKey(42))
state = aviary.set_setpoint(state, 0, jnp.asarray([1.0, 0.0, 0.0, 2.0]))


@jax.jit
def fly(state, n=500):
    return jax.lax.scan(lambda s, _: (aviary.step(s), None), state, None, n)[0]


state = fly(state)
print("drone state [ang_vel, ang_pos, lin_vel, lin_pos]:")
print(aviary.state(state, 0))
