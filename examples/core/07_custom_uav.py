"""Register a custom UAV type: the RocketBrick.

Batched-JAX equivalent of /root/reference/examples/core/07_custom_uav.py +
custom_uavs/rocket_brick.py ("with enough thrust, you can make a brick
fly"): a 1 kg brick with quadratic drag and one fueled booster. Custom
vehicles implement the small duck-typed handle interface and register via
``register_drone_type`` (the functional ``drone_type_mappings``,
aviary.py:122-130).
"""

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct

from pyflyt_tpu.core import Aviary, DroneSpec, integrator, register_drone_type
from pyflyt_tpu.core.state import Body6DoF
from pyflyt_tpu.ops import boosters


@struct.dataclass
class BrickState:
    body: Body6DoF
    view: jnp.ndarray  # (4, 3) standard readout
    booster: boosters.BoosterState
    setpoint: jnp.ndarray  # (2,): [ignition, throttle]
    contact: jnp.ndarray
    physics_steps: jnp.ndarray


class RocketBrickHandle:
    """Custom vehicle: implements the Aviary handle interface."""

    collision_radius = 0.2

    MASS = 1.0
    INERTIA = jnp.asarray([0.016, 0.016, 0.026])
    DRAG_K = 0.5 * 1.225 * 1.2 * 0.04  # ½ρ·Cd·A
    CORNERS = jnp.asarray(
        [[sx * 0.2, sy * 0.1, sz * 0.06]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )

    def __init__(self, spec, physics_hz):
        self.physics_period = 1.0 / physics_hz
        self.booster_params = boosters.BoosterParams(
            positions=jnp.asarray([[0.0, 0.0, 0.0]]),
            thrust_unit=jnp.asarray([[0.0, 0.0, 1.0]]),
            tau=jnp.asarray([0.01]),
            total_fuel_mass=jnp.asarray([1.0]),
            max_fuel_rate=jnp.asarray([0.1]),
            max_inertia=jnp.asarray([[0.0, 0.0, 0.0]]),
            min_thrust=jnp.asarray([0.0]),
            max_thrust=jnp.asarray([30.0]),
            reignitable=jnp.asarray([True]),
            noise_ratio=jnp.asarray([0.0]),
        )

    def _view(self, body):
        from pyflyt_tpu.core import math as pm

        R = pm.quat_to_rotmat(body.quat)
        return jnp.stack(
            [
                jnp.einsum("ji,j->i", R, body.ang_vel),
                pm.quat_to_euler(body.quat),
                jnp.einsum("ji,j->i", R, body.lin_vel),
                body.pos,
            ]
        )

    def init(self, start_pos, start_orn):
        from pyflyt_tpu.core import math as pm

        body = Body6DoF(
            pos=start_pos, quat=pm.euler_to_quat(start_orn),
            lin_vel=jnp.zeros(3), ang_vel=jnp.zeros(3),
        )
        return BrickState(
            body=body,
            view=self._view(body),
            booster=boosters.init(self.booster_params),
            setpoint=jnp.zeros(2),
            contact=jnp.zeros((), bool),
            physics_steps=jnp.zeros((), jnp.int32),
        )

    def control(self, st):
        return st  # the setpoint drives the booster directly

    def physics(self, st, key, wind_fn):
        bst, thrust, _, _ = boosters.update(
            st.booster, self.booster_params,
            st.setpoint[0:1], jnp.clip(st.setpoint[1:2], 0.0, 1.0),
            self.physics_period,
        )
        force = jnp.asarray([0.0, 0.0, 1.0]) * thrust[0]
        drag = -jnp.sign(st.view[2]) * self.DRAG_K * st.view[2] ** 2
        rb = integrator.RigidBodyParams(mass=self.MASS, inertia=self.INERTIA)
        new_view = self._view(st.body)
        body = integrator.step(
            st.body, rb, force + drag, jnp.zeros(3), self.physics_period
        )
        body, contact = integrator.ground_contact(
            body, rb, integrator.ContactGeom(points=self.CORNERS)
        )
        return st.replace(
            body=body, view=new_view, booster=bst, contact=contact,
            physics_steps=st.physics_steps + 1,
        )

    def ballistic(self, st):
        rb = integrator.RigidBodyParams(mass=self.MASS, inertia=self.INERTIA)
        body = integrator.step(
            st.body, rb, jnp.zeros(3), jnp.zeros(3), self.physics_period
        )
        body, contact = integrator.ground_contact(
            body, rb, integrator.ContactGeom(points=self.CORNERS)
        )
        return st.replace(body=body, contact=contact,
                          physics_steps=st.physics_steps + 1)

    def set_setpoint(self, st, sp):
        return st.replace(setpoint=jnp.asarray(sp))

    def view(self, st):
        return st.view

    def aux(self, st):
        return boosters.get_states(st.booster)

    def pos(self, st):
        return st.body.pos


register_drone_type("rocket_brick", RocketBrickHandle)

aviary = Aviary(
    start_pos=[[0.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="rocket_brick"),),
)
state = aviary.reset(jax.random.PRNGKey(0))
state = aviary.set_setpoint(state, 0, jnp.asarray([1.0, 0.8]))  # light it


@jax.jit
def fly(state):
    return jax.lax.scan(lambda s, _: (aviary.step(s), None), state, None, 240)[0]


state = fly(state)
print("brick altitude after 1 s of 80% booster:", float(aviary.state(state, 0)[3, 2]))
print("booster aux [ignition, fuel, throttle]:", aviary.aux_state(state, 0))
