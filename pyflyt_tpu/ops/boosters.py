"""Fueled booster model: ignition latching, throttle floor/lag, fuel burn.

Re-implements /root/reference/PyFlyt/core/abstractions/boosters.py as a pure
batched op. The reference mutates the fuel-tank link's mass/inertia through
``changeDynamics`` (:246-258); here the op returns the fuel mass/inertia so
the vehicle model rebuilds its composite mass properties each physics step
(quasi-static — exactly the reference's per-step update granularity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array


@struct.dataclass
class BoosterParams:
    """Static parameters for n boosters (boosters.py:40-115)."""

    positions: Array  # (n, 3) body-frame thrust application points
    thrust_unit: Array  # (n, 3) unit thrust directions (before gimballing)
    tau: Array  # (n,) throttle ramp time constant
    total_fuel_mass: Array  # (n,)
    max_fuel_rate: Array  # (n,) kg/s at full throttle
    max_inertia: Array  # (n, 3) fuel-tank inertia at full fuel
    min_thrust: Array  # (n,)
    max_thrust: Array  # (n,)
    reignitable: Array  # (n,) bool
    noise_ratio: Array  # (n,)

    @property
    def ratio_min_throttle(self) -> Array:
        return self.min_thrust / self.max_thrust

    @property
    def ratio_throttleable(self) -> Array:
        return 1.0 - self.ratio_min_throttle

    @property
    def ratio_fuel_rate(self) -> Array:
        return self.max_fuel_rate / self.total_fuel_mass


@struct.dataclass
class BoosterState:
    ratio_fuel_remaining: Array  # (..., n)
    throttle: Array  # (..., n)
    ignition_state: Array  # (..., n) bool


def init(
    params: BoosterParams,
    batch_shape: tuple[int, ...] = (),
    starting_fuel_ratio: float | Array = 1.0,
    dtype=jnp.float32,
) -> BoosterState:
    """reset(starting_fuel_ratio) (boosters.py:117-129)."""
    n = params.tau.shape[-1]
    return BoosterState(
        ratio_fuel_remaining=jnp.full((*batch_shape, n), starting_fuel_ratio, dtype),
        throttle=jnp.zeros((*batch_shape, n), dtype),
        ignition_state=jnp.zeros((*batch_shape, n), bool),
    )


def update(
    state: BoosterState,
    params: BoosterParams,
    ignition: Array,
    pwm: Array,
    physics_period: float,
    key: Array | None = None,
) -> tuple[BoosterState, Array, Array, Array]:
    """One physics-step update (``_compute_thrust_mass_inertia``,
    boosters.py:211-259).

    Returns ``(state, thrust, fuel_mass, fuel_inertia)`` with thrust (..., n)
    scalar magnitudes, fuel mass (..., n) and fuel inertia (..., n, 3).
    """
    # ignition latching for non-reignitable engines (:222-224)
    ignition_state = (~params.reignitable & state.ignition_state) | (ignition > 0.5)

    # throttle floor when lit (:227-229) + first-order lag (:231-234)
    target = ignition_state * (
        pwm * params.ratio_throttleable + params.ratio_min_throttle
    )
    throttle = state.throttle + (physics_period / params.tau) * (
        target - state.throttle
    )
    if key is not None:  # multiplicative noise (:236-241)
        noise = jax.random.normal(key, jnp.shape(throttle), throttle.dtype)
        throttle = throttle + noise * throttle * params.noise_ratio

    # hard cutoff at zero fuel (:244)
    throttle = throttle * (state.ratio_fuel_remaining > 0.0)

    # fuel depletion (:246-250)
    fuel = jnp.clip(
        state.ratio_fuel_remaining
        - throttle * params.ratio_fuel_rate * physics_period,
        0.0,
        1.0,
    )

    fuel_mass = fuel * params.total_fuel_mass
    fuel_inertia = fuel[..., None] * params.max_inertia
    thrust = throttle * params.max_thrust
    new_state = BoosterState(
        ratio_fuel_remaining=fuel, throttle=throttle, ignition_state=ignition_state
    )
    return new_state, thrust, fuel_mass, fuel_inertia


def get_states(state: BoosterState) -> Array:
    """[ignition…, fuel ratio…, throttle…] (boosters.py:130-147)."""
    return jnp.concatenate(
        [
            state.ignition_state.astype(state.throttle.dtype),
            state.ratio_fuel_remaining,
            state.throttle,
        ],
        axis=-1,
    )
