"""Multiple drones with heterogeneous control rates in one simulation.

Batched-JAX equivalent of /root/reference/examples/core/02_multi_drone.py +
08_mixed_drones.py: a rocket, a quadx and a fixedwing stepped in lockstep.
"""

import jax
import jax.numpy as jnp

from pyflyt_tpu.core import Aviary, DroneSpec

aviary = Aviary(
    start_pos=[[0.0, 0.0, 100.0], [3.0, 0.0, 1.0], [6.0, 0.0, 30.0]],
    start_orn=[[0.0, 0.0, 0.0]] * 3,
    specs=(
        DroneSpec(drone_type="rocket", control_hz=120),
        DroneSpec(drone_type="quadx", control_hz=60, mode=7),
        DroneSpec(drone_type="fixedwing", control_hz=120, mode=0),
    ),
)

state = aviary.reset(jax.random.PRNGKey(0))
state = aviary.set_all_setpoints(
    state,
    [
        jnp.zeros(7),                            # rocket: free fall
        jnp.asarray([3.0, 0.0, 0.0, 1.5]),       # quadx: hold position
        jnp.asarray([0.0, 0.0, 0.0, 0.6]),       # fixedwing: cruise
    ],
)


@jax.jit
def fly(state):
    return jax.lax.scan(lambda s, _: (aviary.step(s), None), state, None, 240)[0]


state = fly(state)
for i in range(3):
    print(f"drone {i} position:", aviary.state(state, i)[3])
