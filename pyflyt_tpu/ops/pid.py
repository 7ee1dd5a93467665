"""Functional array PID controller.

Re-implements the reference's numba jitclass PID
(/root/reference/PyFlyt/core/abstractions/pid.py:68-91) as a pure function:
clipped integral, derivative on error, clipped output. Gains/limits live in a
params pytree so one call services a whole batch of controllers.
"""

from __future__ import annotations

import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array


@struct.dataclass
class PIDParams:
    kp: Array
    ki: Array
    kd: Array
    lim: Array
    period: float = struct.field(pytree_node=False)


@struct.dataclass
class PIDState:
    integral: Array
    prev_error: Array


def init(params: PIDParams, batch_shape: tuple[int, ...] = ()) -> PIDState:
    """Zero-initialized controller state shaped like the gains (+ batch)."""
    z = jnp.zeros((*batch_shape, *jnp.shape(params.kp)), dtype=jnp.result_type(params.kp))
    return PIDState(integral=z, prev_error=z)


def reset(state: PIDState) -> PIDState:
    return PIDState(
        integral=jnp.zeros_like(state.integral),
        prev_error=jnp.zeros_like(state.prev_error),
    )


def step(
    state: PIDState, params: PIDParams, measurement: Array, setpoint: Array
) -> tuple[PIDState, Array]:
    """One PID update. Matches pid.py:68-91 exactly:

    ``i' = clip(i + ki e T, ±lim);  out = clip(kp e + i' + kd (e - e_prev)/T, ±lim)``
    """
    error = setpoint - measurement
    integral = jnp.clip(
        state.integral + params.ki * error * params.period, -params.lim, params.lim
    )
    derivative = params.kd * (error - state.prev_error) / params.period
    out = jnp.clip(params.kp * error + integral + derivative, -params.lim, params.lim)
    return PIDState(integral=integral, prev_error=error), out
