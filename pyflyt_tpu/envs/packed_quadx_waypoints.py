"""Packed-state QuadX Waypoints env: the whole agent step is ONE kernel.

The quadx-hover treatment (envs/packed_hover.py) applied to the waypoints
task: ``N`` envs live in the folded ``(rows_for_waypoints(mode), 8, N/8)``
layout of ops/pallas_quadx.py, with the waypoint target buffer stored
CYCLICALLY ROLLED (current target = first 3 waypoint rows, no runtime
gather). ``step`` runs ``env_step_ratio`` aviary steps PLUS the waypoint
task update (body-frame delta tracking, progress/proximity reward shaping,
100-point target-reach overwrite, cyclic target advancement, all-reached
truncation, collision/out-of-bounds termination, done-freeze) in one
``pallas_call``; XLA only assembles the dict observation from packed rows.

Semantics match ``QuadXWaypointsEnv`` exactly with noise off (asserted in
tests/test_packed_waypoints.py); with noise on the motor-noise PRNG stream
differs (kernel counter-hash normals), same distribution. Envelope: modes 0/7/8,
ENU, ``use_yaw_targets=False`` (the stock configuration; yaw-target deltas
would need 4-wide delta rows).

Reference semantics covered (cited against the upstream tree):
- agent-step loop: quadx_base_env.py:248-279
- waypoint task: quadx_waypoints_env.py:128-179 + utils/waypoint_handler.py
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.quadx_waypoints import QuadXWaypointsEnv, QuadXWaypointsState
from pyflyt_tpu.ops import pallas_quadx as pq


@struct.dataclass
class PackedWaypointsState:
    packed: Array  # (rows_for_waypoints(mode), 8, N/8)
    key: Array  # scalar PRNG key driving the kernel noise seeds


def _fold(x: Array) -> Array:
    return x.reshape(x.shape[0], pq.SUBLANES, -1)


@dataclasses.dataclass(frozen=True)
class PackedQuadXWaypointsEnv:
    """Batch-level functional env (reset takes (N, 2) keys, N % 8 == 0)."""

    base: QuadXWaypointsEnv = dataclasses.field(
        default_factory=QuadXWaypointsEnv
    )

    def __post_init__(self):
        assert self.base.flight_mode in (0, 7, 8)
        assert self.base.orn_conv == "ENU_FLU"
        assert not self.base.use_yaw_targets, (
            "packed fast path carries 3-dim target deltas only"
        )
        assert self.base.num_targets <= 4

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self):
        return self.base.action_bounds()

    @property
    def _wb(self) -> int:
        return pq.rows_for(self.base.flight_mode)

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: QuadXWaypointsState) -> Array:
        """Batched QuadXWaypointsState -> packed array (waypoint rows rolled
        so the current target is first)."""
        b = self.base
        nt = b.num_targets
        packed = pq.pack_state(st.drone, b.flight_mode)
        flat = packed.reshape(packed.shape[0], -1)
        n = flat.shape[1]
        f32 = flat.dtype
        env_rows = jnp.stack(
            [
                st.reward.astype(f32),
                st.termination.astype(f32),
                st.truncation.astype(f32),
                st.collision.astype(f32),
                st.out_of_bounds.astype(f32),
                st.step_count.astype(f32),
            ]
        )
        flat = flat.at[pq._RWD : pq._STEP + 1].set(env_rows)
        # cyclic roll: row k holds target (idx + k) mod nt
        ar = (st.wp.idx[:, None] + jnp.arange(nt)[None, :]) % nt
        rolled = jnp.take_along_axis(st.wp.targets, ar[..., None], axis=1)
        pad_t = jnp.zeros((n, 4 - nt, 3), f32)
        tgt_rows = jnp.concatenate([rolled, pad_t], axis=1).reshape(n, 12).T
        tdlt = jnp.concatenate(
            [st.target_deltas, jnp.zeros((n, 4 - nt, 3), f32)], axis=1
        ).reshape(n, 12).T
        wp_rows = jnp.concatenate(
            [
                tgt_rows,
                (nt - st.wp.idx).astype(f32)[None, :],
                st.wp.new_distance[None, :],
                st.wp.old_distance[None, :],
                tdlt,
                st.env_complete.astype(f32)[None, :],
            ],
            axis=0,
        )
        total = pq.rows_for_waypoints(b.flight_mode)
        out = jnp.concatenate(
            [
                flat,
                wp_rows,
                jnp.zeros((total - self._wb - pq.WP_ROWS, n), f32),
            ],
            axis=0,
        )
        return _fold(out)

    def _obs(self, flat: Array) -> dict:
        """Dict observation (quadx_waypoints.py _obs) from packed rows."""
        b = self.base
        ang_vel = flat[pq._VIEW : pq._VIEW + 3].T
        euler = flat[pq._VIEW + 3 : pq._VIEW + 6].T
        att = (
            pm.euler_to_quat(euler)
            if b.angle_representation == "quaternion"
            else euler
        )
        lin_vel = flat[pq._VIEW + 6 : pq._VIEW + 9].T
        lin_pos = flat[pq._VIEW + 9 : pq._VIEW + 12].T
        action = flat[pq._SP : pq._SP + 4].T
        aux = flat[pq._THR : pq._THR + 4].T
        attitude = jnp.concatenate(
            [ang_vel, att, lin_vel, lin_pos, action, aux], axis=-1
        )
        wb = self._wb
        deltas = (
            flat[wb + 15 : wb + 15 + 3 * b.num_targets]
            .T.reshape(-1, b.num_targets, 3)
        )
        return {"attitude": attitude, "target_deltas": deltas}

    # ----- functional env API ---------------------------------------------
    def reset(self, keys: Array) -> tuple[PackedWaypointsState, dict]:
        """Batched reset: the XLA reset path (10 stabilization steps +
        target sampling) packed."""
        st, obs = jax.vmap(self.base.reset)(keys)
        return (
            PackedWaypointsState(
                packed=self.pack_env_state(st),
                key=jax.random.fold_in(keys[0], 0x9ACD),
            ),
            obs,
        )

    def step(
        self, state: PackedWaypointsState, action: Array
    ) -> tuple[PackedWaypointsState, StepOut]:
        b = self.base
        key, sub = jax.random.split(state.key)
        seed = jax.random.randint(sub, (), 0, 2**31 - 1)
        flat = state.packed.reshape(state.packed.shape[0], -1)
        # setpoint := action, applied unconditionally before the inner loop
        # (quadx_base.py:194-201)
        act = jnp.asarray(action, dtype=flat.dtype).T
        flat = flat.at[pq._SP : pq._SP + 4].set(act)
        out = pq.packed_waypoints_step(
            _fold(flat),
            seed,
            b.params,
            b.cfg,
            mode=b.flight_mode,
            noisy=b.noisy_motors,
            inner_steps=b.env_step_ratio,
            dome=b.flight_dome_size,
            max_steps=b.max_steps,
            num_targets=b.num_targets,
            goal_dist=b.goal_reach_distance,
            sparse=b.sparse_reward,
        )
        oflat = out.reshape(out.shape[0], -1)
        wb = self._wb
        step_out = StepOut(
            obs=self._obs(oflat),
            reward=oflat[pq._RWD],
            termination=oflat[pq._TERM] > 0.5,
            truncation=oflat[pq._TRUNC] > 0.5,
            info={
                "collision": oflat[pq._COLL] > 0.5,
                "out_of_bounds": oflat[pq._OOB] > 0.5,
                "env_complete": oflat[wb + 27] > 0.5,
                "num_targets_reached": (
                    b.num_targets - oflat[wb + 12]
                ).astype(jnp.int32),
            },
        )
        return PackedWaypointsState(packed=out, key=key), step_out
