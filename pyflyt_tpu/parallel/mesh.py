"""Mesh construction + env-batch sharding helpers.

Usage (single host, n GPUs)::

    mesh = env_mesh()                       # 1-D ('env',) over all devices
    state = shard_env_batch(state, mesh)    # env axis split across devices
    params = replicate(params, mesh)

Multi-host (one process per host)::

    init_distributed(coordinator_address=..., num_processes=...,
                     process_id=...)        # jax.distributed.initialize()
    mesh = env_mesh()                       # global mesh over all hosts
    # build per-host shards with jax.make_array_from_process_local_data or
    # reset envs under jit with out_shardings=NamedSharding(mesh, P('env'))

Everything downstream is unchanged: the PPO train iteration
(pyflyt_tpu/rl/ppo.py) is one jitted program; XLA partitions it over the
mesh and inserts the gradient all-reduce / resharding collectives.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np


def init_distributed(**kwargs) -> None:
    """Initializes multi-host JAX (call once per host before device use)."""
    jax.distributed.initialize(**kwargs)


def env_mesh(devices=None, axis_name: str = "env"):
    """A 1-D mesh over ``devices`` (default: all global devices)."""
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_env_batch(tree: Any, mesh, axis_name: str = "env") -> Any:
    """Places a pytree with a leading env-batch axis on ``P(axis_name)``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(tree, NamedSharding(mesh, P(axis_name)))


def replicate(tree: Any, mesh) -> Any:
    """Replicates a pytree across every device of the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(tree, NamedSharding(mesh, P()))
