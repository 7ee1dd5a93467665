"""Functional Aviary: the multi-drone simulation orchestrator.

Re-implements /root/reference/PyFlyt/core/aviary.py as a static config +
pure state transitions. The reference's Aviary owns a PyBullet client and a
list of mutable drone objects; here the Aviary is a frozen dataclass of
per-drone specs and ``AviaryState`` is a pytree of per-drone model states, so
``step`` is one jitted program (vmap/scan composable).

Preserved semantics:
- ``updates_per_step = physics_hz / min(control_hz)`` with per-drone control
  gating ``step % (physics_hz / control_hz_i) == 0`` (aviary.py:291-301,
  478-484; base_drone.py:95-102)
- per-iteration order: control → physics (forces from the lagged read state)
  → state read → integrate (aviary.py:478-500)
- boolean contact bookkeeping reset per aviary step (aviary.py:475, 493-496);
  drone-drone contact via sphere proximity at each vehicle's bounding radius
  (the reference uses PyBullet's convex collision)
- ``set_armed``: disarmed drones get no control/physics updates but keep
  integrating ballistically under gravity (aviary.py:422-436, 487-488)
- custom controllers (quadx): pure ``(view, setpoint) -> setpoint`` functions
  with a base mode (base_drone.py:265-285)
- wind-field hook shared by all drones (aviary.py:269-288)

Functional deviations (documented, same capability): flight modes and custom
controllers are trace-time static, so they are part of the Aviary config —
``set_mode`` returns a *new* (Aviary, state) pair instead of mutating.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import integrator
from pyflyt_tpu.core.state import Body6DoF
from pyflyt_tpu.core.struct import tree_select
from pyflyt_tpu.models import fixedwing, quadx, rocket


@struct.dataclass
class AviaryState:
    drones: tuple  # per-drone model state pytrees (heterogeneous)
    armed: Array  # (n,) bool
    contact: Array  # (n,) bool — any contact during the last aviary step
    contact_matrix: Array  # (n, n) bool — drone-drone proximity contacts
    key: Array
    aviary_steps: Array  # int32
    physics_steps: Array  # int32


# ---------------------------------------------------------------------------
# per-type adapters
# ---------------------------------------------------------------------------


class _QuadXHandle:
    collision_radius = 0.065

    def __init__(self, spec: "DroneSpec", physics_hz: int):
        opts = spec.options
        self.mode = spec.mode
        self.custom_controller = spec.custom_controller
        self.cfg = quadx.QuadXConfig(
            drone_model=opts.get("drone_model", "cf2x"),
            control_hz=spec.control_hz,
            physics_hz=physics_hz,
            orn_conv=opts.get("orn_conv", "ENU_FLU"),
            noisy_motors=opts.get("noisy_motors", True),
            min_pwm=opts.get("min_pwm", 0.05),
            max_pwm=opts.get("max_pwm", 1.0),
        )
        self.params = quadx.build_params(self.cfg)

    def init(self, start_pos, start_orn):
        st = quadx.init_state(self.params, self.cfg, start_pos, start_orn)
        return quadx.set_mode(st, self.mode, self.cfg)

    def control(self, st):
        return quadx.update_control(
            st, self.params, self.cfg, self.mode, self.custom_controller
        )

    def physics(self, st, key, wind_fn):
        return quadx.physics_iter(
            st, self.params, self.cfg, key if self.cfg.noisy_motors else None,
            None if wind_fn is None else wind_fn(st.physics_steps, st.body.pos),
        )

    def ballistic(self, st):
        rb = integrator.RigidBodyParams(
            mass=self.params.mass, inertia=self.params.inertia
        )
        body = integrator.step(
            st.body, rb, jnp.zeros(3), jnp.zeros(3), self.cfg.physics_period
        )
        body, contact = integrator.ground_contact(
            body, rb, quadx._contact_geom(self.params)
        )
        # reference skips update_state for disarmed drones
        # (aviary.py:487-488): the read/sensor snapshot stays frozen
        return st.replace(
            body=body,
            contact=contact,
            physics_steps=st.physics_steps + 1,
        )

    def set_setpoint(self, st, sp):
        return st.replace(setpoint=jnp.asarray(sp, self.cfg.dtype))

    def view(self, st):
        return st.read.view

    def aux(self, st):
        return st.throttle

    def pos(self, st):
        return st.body.pos


class _FixedwingHandle:
    collision_radius = 0.5

    def __init__(self, spec: "DroneSpec", physics_hz: int):
        opts = spec.options
        self.mode = spec.mode
        self.cfg = fixedwing.FixedwingConfig(
            drone_model=opts.get("drone_model", "fixedwing"),
            control_hz=spec.control_hz,
            physics_hz=physics_hz,
            starting_velocity=tuple(opts.get("starting_velocity", (20.0, 0.0, 0.0))),
        )
        self.params = fixedwing.build_params(self.cfg)

    def init(self, start_pos, start_orn):
        return fixedwing.init_state(
            self.params, self.cfg, start_pos, start_orn, self.mode
        )

    def control(self, st):
        return fixedwing.update_control(st, self.params, self.cfg, self.mode)

    def physics(self, st, key, wind_fn):
        return fixedwing.physics_iter(st, self.params, self.cfg, key, wind_fn)

    def ballistic(self, st):
        rb = integrator.RigidBodyParams(
            mass=self.params.mass, inertia=self.params.inertia, full_inertia=True
        )
        body = integrator.step(
            st.body, rb, jnp.zeros(3), jnp.zeros(3), self.cfg.physics_period
        )
        body, contact = integrator.ground_contact(
            body,
            rb,
            integrator.ContactGeom(
                points=self.params.contact_points - self.params.com_offset
            ),
        )
        return st.replace(
            body=body,
            contact=contact,
            physics_steps=st.physics_steps + 1,
        )

    def set_setpoint(self, st, sp):
        return st.replace(setpoint=jnp.asarray(sp, self.cfg.dtype))

    def view(self, st):
        return st.read.view

    def aux(self, st):
        return fixedwing.aux_state(st)

    def pos(self, st):
        return st.body.pos


class _RocketHandle:
    collision_radius = 0.6

    def __init__(self, spec: "DroneSpec", physics_hz: int):
        opts = spec.options
        self.cfg = rocket.RocketConfig(
            drone_model=opts.get("drone_model", "rocket"),
            control_hz=spec.control_hz,
            physics_hz=physics_hz,
            starting_fuel_ratio=opts.get("starting_fuel_ratio", 0.05),
        )
        self.params = rocket.build_params(self.cfg)

    def init(self, start_pos, start_orn):
        return rocket.init_state(self.params, self.cfg, start_pos, start_orn)

    def control(self, st):
        return rocket.update_control(st, self.params, self.cfg)

    def physics(self, st, key, wind_fn):
        return rocket.physics_iter(st, self.params, self.cfg, key, wind_fn)

    def ballistic(self, st):
        com = rocket._current_com(st, self.params)
        fuel_mass = (
            st.booster.ratio_fuel_remaining * self.params.booster.total_fuel_mass
        )
        fuel_inertia = (
            st.booster.ratio_fuel_remaining[..., None]
            * self.params.booster.max_inertia
        )
        mass, com, inertia = rocket.mass_properties(
            self.params, fuel_mass, fuel_inertia
        )
        rb = integrator.RigidBodyParams(mass=mass, inertia=inertia, full_inertia=True)
        body = integrator.step(
            st.body, rb, jnp.zeros(3), jnp.zeros(3), self.cfg.physics_period
        )
        body, contact = integrator.ground_contact(
            body,
            rb,
            integrator.ContactGeom(points=self.params.contact_points - com),
        )
        return st.replace(
            body=body,
            contact=contact,
            physics_steps=st.physics_steps + 1,
        )

    def set_setpoint(self, st, sp):
        return st.replace(setpoint=jnp.asarray(sp, self.cfg.dtype))

    def view(self, st):
        return st.read.view

    def aux(self, st):
        return rocket.aux_state(st)

    def pos(self, st):
        return st.body.pos


_HANDLE_TYPES: dict[str, type] = {
    "quadx": _QuadXHandle,
    "fixedwing": _FixedwingHandle,
    "rocket": _RocketHandle,
}


def register_drone_type(name: str, handle_cls: type) -> None:
    """The functional ``drone_type_mappings`` (aviary.py:122-130): register a
    custom vehicle handle class (same duck-typed interface as the built-ins).
    """
    _HANDLE_TYPES[name] = handle_cls


@dataclasses.dataclass(frozen=True)
class DroneSpec:
    """Static per-drone configuration."""

    drone_type: str = "quadx"
    control_hz: int = 120
    mode: int = 0
    options: Any = dataclasses.field(default_factory=dict)
    custom_controller: Callable | None = None  # quadx only


class Aviary:
    """Static simulation configuration + pure transition methods.

    Construction mirrors Aviary(start_pos, start_orn, drone_type,
    drone_options, ...) (aviary.py:42-167); ``specs`` gives full per-drone
    control (mixed fleets, modes, rates — aviary.py:247-266).
    """

    def __init__(
        self,
        start_pos,
        start_orn,
        drone_type: str | None = "quadx",
        drone_options: dict | None = None,
        specs: tuple[DroneSpec, ...] | None = None,
        physics_hz: int = 240,
        wind_fn=None,
        obstacles=None,
        obstacle_response: bool = False,
    ):
        """``obstacles``: optional ``pyflyt_tpu.core.camera.Boxes`` of static
        scene geometry — the functional analogue of ``loadOBJ`` +
        ``register_all_new_bodies`` (core/utils/load_objs.py:8-46,
        aviary.py:309): obstacle proximity feeds the per-drone contact flags
        and the boxes render in third-person views. By default detection
        only (every stock task treats obstacle contact as terminal, so the
        post-contact state is never consumed); ``obstacle_response=True``
        additionally applies a restitution-0 impulse + positional projection
        per physics iteration — the sphere-proxy analogue of PyBullet's
        collision response for custom user scenes (the drone's bounding
        sphere vs each OBB, approaching normal velocity cancelled; no
        contact torque since the proxy sphere is centred on the CoM)."""
        import numpy as np

        self.start_pos = np.asarray(start_pos, dtype=np.float32)
        self.start_orn = np.asarray(start_orn, dtype=np.float32)
        assert self.start_pos.ndim == 2 and self.start_pos.shape[-1] == 3
        n = self.start_pos.shape[0]
        if specs is None:
            specs = tuple(
                DroneSpec(drone_type=drone_type, options=dict(drone_options or {}))
                for _ in range(n)
            )
        assert len(specs) == n
        self.specs = specs
        self.physics_hz = physics_hz
        self.wind_fn = wind_fn
        self.obstacles = obstacles
        self.obstacle_response = obstacle_response and obstacles is not None
        self.handles = [
            _HANDLE_TYPES[s.drone_type](s, physics_hz) for s in specs
        ]
        control_rates = [s.control_hz for s in specs]
        for hz in control_rates:
            assert physics_hz % hz == 0, (
                "`physics_hz` must be integer multiple of every `control_hz`"
            )
        # loop rates must form common multiples of each other
        # (aviary.py:291-301) — otherwise the per-iteration gating below
        # produces non-uniform control intervals
        lo = min(control_rates)
        for hz in control_rates:
            assert hz % lo == 0, (
                f"all `control_hz` must be integer multiples of the lowest "
                f"({lo}); got {sorted(set(control_rates))}"
            )
        self.updates_per_step = physics_hz // lo
        self.control_ratios = [physics_hz // hz for hz in control_rates]

    @property
    def num_drones(self) -> int:
        return len(self.specs)

    def describe(self) -> str:
        """Human-readable fleet dump (the reference's ``print_all_bodies`` /
        ``get_joint_info`` debug helpers — aviary.py:412-420,
        base_drone.py:287-300)."""
        lines = [
            f"Aviary: {self.num_drones} drone(s), physics {self.physics_hz} Hz,"
            f" updates_per_step {self.updates_per_step},"
            f" wind={'yes' if self.wind_fn is not None else 'no'},"
            f" obstacles={0 if self.obstacles is None else self.obstacles.centers.shape[0]}"
        ]
        for i, (s, h) in enumerate(zip(self.specs, self.handles)):
            lines.append(
                f"  [{i}] {s.drone_type} mode={s.mode} control={s.control_hz}Hz"
                f" spawn={self.start_pos[i].tolist()}"
                f" r_col={h.collision_radius}"
            )
        return "\n".join(lines)

    # ----- construction / reset -------------------------------------------
    def reset(self, key: Array) -> AviaryState:
        drones = tuple(
            h.init(jnp.asarray(p), jnp.asarray(o))
            for h, p, o in zip(self.handles, self.start_pos, self.start_orn)
        )
        n = self.num_drones
        return AviaryState(
            drones=drones,
            armed=jnp.ones((n,), bool),
            contact=jnp.zeros((n,), bool),
            contact_matrix=jnp.zeros((n, n), bool),
            key=key,
            aviary_steps=jnp.zeros((), jnp.int32),
            physics_steps=jnp.zeros((), jnp.int32),
        )

    # ----- setters ----------------------------------------------------------
    def set_setpoint(self, state: AviaryState, index: int, setpoint) -> AviaryState:
        drones = list(state.drones)
        drones[index] = self.handles[index].set_setpoint(drones[index], setpoint)
        return state.replace(drones=tuple(drones))

    def set_all_setpoints(self, state: AviaryState, setpoints) -> AviaryState:
        for i, sp in enumerate(setpoints):
            state = self.set_setpoint(state, i, sp)
        return state

    def set_armed(self, state: AviaryState, armed) -> AviaryState:
        armed = jnp.asarray(armed, bool).reshape(self.num_drones)
        return state.replace(armed=armed)

    def set_mode(self, state: AviaryState, modes) -> tuple["Aviary", AviaryState]:
        """Returns a NEW (Aviary, state) with the given flight modes (modes
        are trace-time static — functional analogue of aviary.py:438-452)."""
        if isinstance(modes, int):
            modes = [modes] * self.num_drones
        new_specs = tuple(
            dataclasses.replace(s, mode=m) for s, m in zip(self.specs, modes)
        )
        new_av = Aviary(
            self.start_pos,
            self.start_orn,
            specs=new_specs,
            physics_hz=self.physics_hz,
            wind_fn=self.wind_fn,
            obstacles=self.obstacles,
        )
        drones = list(state.drones)
        for i, (h, m) in enumerate(zip(new_av.handles, modes)):
            kind = new_av.specs[i].drone_type
            if kind == "quadx":
                drones[i] = quadx.set_mode(drones[i], m, h.cfg)
            elif kind == "fixedwing":
                # fixedwing.set_mode zeroes the setpoint at the mode's size
                # (fixedwing.py:203-224)
                drones[i] = drones[i].replace(
                    setpoint=jnp.zeros(6 if m == -1 else 4, h.cfg.dtype)
                )
            elif kind == "rocket":
                assert m == 0, "rocket supports flight mode 0 only"
        return new_av, state.replace(drones=tuple(drones))

    # ----- readouts ---------------------------------------------------------
    def state(self, state: AviaryState, index: int) -> Array:
        """The (4, 3) drone state view (aviary.py:338-353)."""
        return self.handles[index].view(state.drones[index])

    def aux_state(self, state: AviaryState, index: int) -> Array:
        return self.handles[index].aux(state.drones[index])

    def all_states(self, state: AviaryState) -> list[Array]:
        return [self.state(state, i) for i in range(self.num_drones)]

    # ----- stepping ---------------------------------------------------------
    def _pairwise_contacts(self, drones: tuple) -> Array:
        n = self.num_drones
        if n == 1:
            return jnp.zeros((1, 1), bool)
        pos = jnp.stack([h.pos(d) for h, d in zip(self.handles, drones)])
        radii = jnp.asarray([h.collision_radius for h in self.handles])
        diff = pos[:, None, :] - pos[None, :, :]
        dist = jnp.linalg.norm(diff, axis=-1)
        thresh = radii[:, None] + radii[None, :]
        mat = dist < thresh
        return mat & ~jnp.eye(n, dtype=bool)

    def _box_closest_points(self, pos: Array) -> tuple[Array, Array, Array]:
        """Sphere-vs-OBB support math shared by detection and response:
        ``pos`` (..., 3) centers -> (local, clamped, d2) in each box frame,
        shapes (..., k, 3) / (..., k, 3) / (..., k)."""
        ob = self.obstacles
        rel = pos[..., None, :] - ob.centers
        local = jnp.einsum(
            "kij,...kj->...ki", jnp.swapaxes(ob.rotations, -1, -2), rel
        , precision="highest")
        clamped = jnp.clip(local, -ob.half_extents, ob.half_extents)
        d2 = jnp.sum((local - clamped) ** 2, axis=-1)
        return local, clamped, d2

    def _obstacle_contacts(self, drones: tuple) -> Array:
        """(n,) bool — per-drone sphere-vs-OBB proximity to the obstacles."""
        n = self.num_drones
        if self.obstacles is None:
            return jnp.zeros((n,), bool)
        pos = jnp.stack([h.pos(d) for h, d in zip(self.handles, drones)])
        radii = jnp.asarray([h.collision_radius for h in self.handles])
        _, _, d2 = self._box_closest_points(pos)  # (n, k)
        return jnp.any(d2 < (radii[:, None] ** 2), axis=-1)

    def _obstacle_impulse(self, body, radius: float):
        """Restitution-0 sphere-vs-OBB response: project the body out of the
        deepest-penetrating box and cancel the approaching normal velocity.
        The sphere-proxy analogue of PyBullet's rigid contact solve for
        ``loadOBJ`` scene bodies (core/utils/load_objs.py:8-46); no torque
        (the proxy sphere is centred on the CoM)."""
        ob = self.obstacles
        local, clamped, d2 = self._box_closest_points(body.pos)  # (k, ...)
        delta = local - clamped
        outside = d2 > 1e-12
        dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
        n_out = delta / dist[:, None]
        # centre inside the box: push out along the least-penetrated face
        face_gap = ob.half_extents - jnp.abs(local)  # (k, 3) >= 0 here
        axis = jnp.argmin(face_gap, axis=-1)
        sign = jnp.sign(
            jnp.take_along_axis(local, axis[:, None], axis=-1)[:, 0]
        )
        n_in = jnp.where(sign[:, None] == 0.0, 1.0, sign[:, None]) * jax.nn.one_hot(
            axis, 3, dtype=local.dtype
        )
        pen = jnp.where(
            outside,
            radius - dist,
            radius + jnp.min(face_gap, axis=-1),
        )
        n_local = jnp.where(outside[:, None], n_out, n_in)
        n_world = jnp.einsum("kij,kj->ki", ob.rotations, n_local, precision="highest")
        k_best = jnp.argmax(pen)
        pen_b = jnp.maximum(pen[k_best], 0.0)
        hit = pen[k_best] > 0.0
        n_b = n_world[k_best]
        v_n = jnp.minimum(jnp.dot(body.lin_vel, n_b, precision="highest"), 0.0)
        pos = jnp.where(hit, body.pos + pen_b * n_b, body.pos)
        lin_vel = jnp.where(hit, body.lin_vel - v_n * n_b, body.lin_vel)
        return body.replace(pos=pos, lin_vel=lin_vel)

    def step(self, state: AviaryState) -> AviaryState:
        """One aviary step = ``updates_per_step`` physics iterations
        (aviary.py:472-503)."""
        n = self.num_drones
        any_contact = jnp.zeros((n,), bool)
        any_matrix = jnp.zeros((n, n), bool)
        key = state.key
        drones = list(state.drones)

        for it in range(self.updates_per_step):
            for i, (h, ratio) in enumerate(zip(self.handles, self.control_ratios)):
                armed_i = state.armed[i]
                if it % ratio == 0:
                    controlled = h.control(drones[i])
                    drones[i] = tree_select(armed_i, controlled, drones[i])
                key, sub = jax.random.split(key)
                stepped = h.physics(drones[i], sub, self.wind_fn)
                ballistic = h.ballistic(drones[i])
                drones[i] = tree_select(armed_i, stepped, ballistic)
                if self.obstacle_response:
                    drones[i] = drones[i].replace(
                        body=self._obstacle_impulse(
                            drones[i].body, h.collision_radius
                        )
                    )
            contacts = jnp.stack([d.contact for d in drones])
            matrix = self._pairwise_contacts(tuple(drones))
            obstacle_hits = self._obstacle_contacts(tuple(drones))
            any_contact = (
                any_contact | contacts | jnp.any(matrix, axis=-1) | obstacle_hits
            )
            any_matrix = any_matrix | matrix

        return state.replace(
            drones=tuple(drones),
            armed=state.armed,
            contact=any_contact,
            contact_matrix=any_matrix,
            key=key,
            aviary_steps=state.aviary_steps + 1,
            physics_steps=state.physics_steps + self.updates_per_step,
        )
