"""Fly two consecutive position setpoints and log the xyz trajectory.

Batched-JAX equivalent of /root/reference/examples/core/03_control.py (+ the
03_control_NED_FRD.py variant): the 1000-step rollout is a ``lax.scan`` —
the whole flight compiles to one XLA program, and the log comes back as a
single (1000, 3) array instead of a Python-loop append.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.core import Aviary, DroneSpec

aviary = Aviary(
    start_pos=[[0.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=7),),  # mode 7: x, y, yaw, z
)

state = aviary.reset(jax.random.PRNGKey(0))


def fly(state, setpoint, steps):
    """Scan ``steps`` aviary steps under one setpoint, logging lin_pos."""
    state = aviary.set_setpoint(state, 0, setpoint)

    def body(st, _):
        st = aviary.step(st)
        return st, aviary.state(st, 0)[3]  # row 3 = linear position

    return jax.lax.scan(body, state, None, length=steps)


# first 500 steps: go to x=1, y=0, z=1
state, log_a = jax.jit(fly, static_argnums=2)(state, jnp.asarray([1.0, 0.0, 0.0, 1.0]), 500)
# next 500 steps: go to x=0, y=0, z=2, yaw 45 degrees
state, log_b = jax.jit(fly, static_argnums=2)(state, jnp.asarray([0.0, 0.0, jnp.pi / 4, 2.0]), 500)

log = np.concatenate([np.asarray(log_a), np.asarray(log_b)])
print("position after leg 1:", log[499], " after leg 2:", log[-1])

# same flight plan under NED/FRD conventions (north-east-down frame): the
# reference ships *_NED_FRD.py twins of each example; here it is one option.
aviary_ned = Aviary(
    start_pos=[[0.0, 0.0, -1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=7, options={"orn_conv": "NED_FRD"}),),
)
st = aviary_ned.reset(jax.random.PRNGKey(0))
st = aviary_ned.set_setpoint(st, 0, jnp.asarray([1.0, 0.0, 0.0, -2.0]))  # z down
for _ in range(5):
    st = jax.jit(aviary_ned.step)(st)
print("NED position:", np.asarray(aviary_ned.state(st, 0)[3]))

try:  # plot if matplotlib is around (the reference always plots)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(1000) / 120.0
    for i, n in enumerate("xyz"):
        plt.plot(t, log[:, i], label=n)
    plt.legend(), plt.xlabel("time [s]"), plt.ylabel("position [m]")
    plt.savefig("control_log.png", dpi=80)
    print("wrote control_log.png")
except ImportError:
    pass
