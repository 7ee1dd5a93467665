"""Spawns three different drone types with per-drone options, then reads
all their states.

Batched-JAX equivalent of /root/reference/examples/core/08_mixed_drones.py:
a rocket (defaults), a quadx with a non-default airframe, and a fixedwing
spawned at rest — each with its own spawn options and flight mode, stepped
in lockstep inside one jitted scan.
"""

import jax
import jax.numpy as jnp

from pyflyt_tpu.core import Aviary, DroneSpec

# the starting position and orientations (08_mixed_drones.py:7-8)
start_pos = [[0.0, 5.0, 5.0], [3.0, 3.0, 1.0], [5.0, 0.0, 1.0]]
start_orn = [[0.0, 0.0, 0.0]] * 3

# individual spawn options for each drone (08_mixed_drones.py:10-13)
aviary = Aviary(
    start_pos=start_pos,
    start_orn=start_orn,
    specs=(
        DroneSpec(drone_type="rocket"),
        DroneSpec(
            drone_type="quadx",
            mode=7,  # env.set_mode([0, 7, 0]) (08_mixed_drones.py:25)
            options=dict(drone_model="primitive_drone"),
        ),
        DroneSpec(
            drone_type="fixedwing",
            mode=0,
            options=dict(starting_velocity=(0.0, 0.0, 0.0)),
        ),
    ),
)

state = aviary.reset(jax.random.PRNGKey(0))
state = aviary.set_all_setpoints(
    state,
    [
        jnp.zeros(7),                       # rocket: unlit, ballistic
        jnp.asarray([3.0, 3.0, 0.0, 1.5]),  # quadx: hold position
        jnp.asarray([0.0, 0.0, 0.0, 0.0]),  # fixedwing: no actuation
    ],
)


@jax.jit
def fly(state):
    # 1000 steps at 120 Hz control ≈ 8 seconds (08_mixed_drones.py:28)
    return jax.lax.scan(lambda s, _: (aviary.step(s), None), state, None, 1000)[0]


state = fly(state)
for i in range(3):
    # env.all_states / env.all_aux_states (08_mixed_drones.py:29-31)
    print(f"drone {i} state:", [jnp.round(v, 3) for v in aviary.state(state, i)])
    print(f"drone {i} aux:", jnp.round(aviary.aux_state(state, i), 3))
