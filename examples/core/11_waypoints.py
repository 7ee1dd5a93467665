"""Drive the waypoint handler directly: chase a ring of fixed waypoints.

Batched-JAX equivalent of /root/reference/examples/core/11_waypoints.py: the
reference wires a ``WaypointHandler`` to a PID-controlled drone outside any
gym env. Here the handler is a pure struct — ``reset`` samples (or takes)
targets, ``update_distances``/``advance_targets`` are jittable transitions —
so the same chase loop runs under ``jit`` and batches under ``vmap``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.core import Aviary, DroneSpec
from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.utils.waypoints import WaypointHandler

# an ascending ring (the reference's NED waypoint list, flipped to ENU up)
ring = jnp.asarray(
    [
        [4.05, 2.94, 6.0],
        [1.55, 4.76, 7.0],
        [-1.55, 4.76, 8.0],
        [-4.05, 2.94, 9.0],
        [-5.0, 0.0, 10.0],
    ]
)

handler = WaypointHandler(num_targets=5, goal_reach_distance=0.3,
                          flight_dome_size=12.0)
ws = handler.reset(jax.random.PRNGKey(0))
ws = ws.replace(targets=ring)  # fixed plan instead of sampled targets

aviary = Aviary(
    start_pos=[[5.0, 0.0, 5.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=7),),
)
state = aviary.reset(jax.random.PRNGKey(1))

step = jax.jit(aviary.step)
for i in range(6000):
    view = aviary.state(state, 0)
    tgt = ws.targets[jnp.minimum(ws.idx, handler.num_targets - 1)]
    state = aviary.set_setpoint(
        state, 0, jnp.asarray([tgt[0], tgt[1], 0.0, tgt[2]])
    )
    state = step(state)
    quat = pm.euler_to_quat(view[1])
    ws, _ = handler.update_distances(ws, view[1], view[3], quat)
    if bool(handler.target_reached(ws)):
        print(f"reached waypoint {int(ws.idx)} at step {i}: {np.asarray(tgt)}")
        ws = handler.advance_targets(ws)
        # distances carry over between targets exactly like the reference's
        # advance (waypoint_handler.py:161-172); refresh against the new one
        view = aviary.state(state, 0)
        ws, _ = handler.update_distances(
            ws, view[1], view[3], pm.euler_to_quat(view[1])
        )
    if bool(handler.all_targets_reached(ws)):
        print("all waypoints reached")
        break
