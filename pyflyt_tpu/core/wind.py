"""Functional wind-field models.

Re-implements the reference's wind stack as pure pytree callables:

- ``WindFieldClass`` protocol (/root/reference/PyFlyt/core/abstractions/
  base_wind_field.py:9-55): a wind field maps ``(time, positions)`` to wind
  velocities. Here the callable is a struct dataclass (a pytree), so its sampled
  parameters (base wind vector, PRNG key) live inside jitted env state and
  batch transparently under ``vmap``.
- ``SimpleWind`` (core/wind/simple_wind.py:7-22): log-height thermal + noise.
- ``GaussianWind`` (fork, core/wind/gaussian_wind.py:7-57): base wind vector
  (uniform ±7, ±7, ±2 by default) plus clipped Gaussian gusts resampled once
  per unique sim time, with NED→ENU output remap.

Functional signature: ``wind(physics_step, position) -> wind_velocity`` where
``physics_step`` is the int32 physics-iteration counter (the reference's
per-unique-``time`` gust memoization becomes a deterministic
``fold_in(key, physics_step)`` draw — same resample-per-physics-step
semantics, but stateless and batchable).
"""

from __future__ import annotations

from typing import Protocol

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array


class WindFn(Protocol):
    """Wind velocity sampler: ``(physics_step int32, (..., 3) ENU positions)
    -> (..., 3) ENU wind velocities``."""

    def __call__(self, physics_step: Array, position: Array) -> Array: ...


@struct.dataclass
class ConstantWind:
    """Uniform constant wind (the simplest valid field; handy for tests)."""

    velocity: Array  # (3,) ENU

    def __call__(self, physics_step: Array, position: Array) -> Array:
        return jnp.broadcast_to(self.velocity, position.shape)


@struct.dataclass
class SimpleWind:
    """Thermal demo field (core/wind/simple_wind.py:14-22).

    xy wind is zero; z wind is ``log(clip(z + 1, 0, ∞)) · strength``; Gaussian
    noise is added to all components (fresh draw per physics step via
    ``fold_in`` instead of the reference's global RandomState).
    """

    key: Array  # PRNG key for the per-step noise
    strength: Array = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def __call__(self, physics_step: Array, position: Array) -> Array:
        height = jnp.clip(position[..., 2] + 1.0, 0.0, None)
        thermal = jnp.log(jnp.maximum(height, 1e-12)) * self.strength
        thermal = jnp.where(height > 0.0, thermal, 0.0)
        wind = jnp.zeros_like(position).at[..., 2].set(thermal)
        noise_key = jax.random.fold_in(self.key, physics_step)
        return wind + jax.random.normal(noise_key, position.shape, position.dtype)


@struct.dataclass
class GaussianWind:
    """Fork wind model (core/wind/gaussian_wind.py:7-57).

    ``wind = base + clip(N(0,1), ±max_gust)`` per axis, resampled once per
    physics step (the reference memoizes per unique sim time — one gust draw
    per physics step). ``orn_conv='NED_FRD'`` treats base+gust as NED
    components and emits the ENU-frame equivalent (x↔y swap, z negated),
    mirroring gaussian_wind.py:48-55.
    """

    base_wind: Array  # (..., 3) in the configured convention
    key: Array  # PRNG key for gusts
    max_gust: Array = struct.field(default_factory=lambda: jnp.asarray(7.0))
    orn_conv: str = struct.field(pytree_node=False, default="ENU_FLU")

    @classmethod
    def init(
        cls,
        key: Array,
        base_wind: Array | None = None,
        max_gust: float = 7.0,
        orn_conv: str = "ENU_FLU",
        dtype=jnp.float32,
    ) -> "GaussianWind":
        """Samples the base wind U([-7,-7,-2], [7,7,2]) when not given
        (gaussian_wind.py:17-21)."""
        base_key, gust_key = jax.random.split(key)
        if base_wind is None:
            low = jnp.asarray([-7.0, -7.0, -2.0], dtype=dtype)
            high = jnp.asarray([7.0, 7.0, 2.0], dtype=dtype)
            base_wind = jax.random.uniform(
                base_key, (3,), dtype=dtype, minval=low, maxval=high
            )
        else:
            base_wind = jnp.asarray(base_wind, dtype=dtype)
        return cls(base_wind=base_wind, key=gust_key, max_gust=jnp.asarray(max_gust, dtype=dtype), orn_conv=orn_conv)

    def __call__(self, physics_step: Array, position: Array) -> Array:
        gust_key = jax.random.fold_in(self.key, physics_step)
        gust = jax.random.normal(gust_key, self.base_wind.shape, position.dtype)
        wind = self.base_wind + jnp.clip(gust, -self.max_gust, self.max_gust)
        if self.orn_conv == "NED_FRD":
            # user components are NED; the sim integrates ENU
            wind = jnp.stack([wind[..., 1], wind[..., 0], -wind[..., 2]], axis=-1)
        return jnp.broadcast_to(wind, position.shape)
