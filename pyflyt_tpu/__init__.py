"""pyflyt_tpu: a batched, on-device UAV flight simulation suite for RL
research.

A from-scratch rebuild of the capabilities of PyFlyt (reference:
/root/reference, a PyBullet-based UAV simulator) as a batched, pure-JAX
flight-dynamics engine that runs on a GPU (and, for tests, the CPU):

- state lives in pytrees, physics is pure functions (`jit`/`vmap`/`scan`)
- thousands of simulation instances step in lockstep on one device
- multi-device scaling via `jax.sharding.Mesh` + `shard_map`
- Gymnasium / PettingZoo compatibility shims wrap the functional core

Subpackages:
    core      math, rigid-body integrator, Aviary, camera, wind fields
    ops       physics component operators (motors, aero surfaces, boosters,
              gimbals, PID, the Pallas fast-path kernel)
    models    vehicle dynamics + control cascades (QuadX, Fixedwing, Rocket)
    envs      functional task environments + Gymnasium/PettingZoo wrappers
              (incl. multi-agent and the fork's quadx_mod envs)
    rl        PPO training stack (pure JAX) + rl_training CLIs
    parallel  device-mesh sharding utilities
    utils     loggers, results comparison, telemetry, NaN guards
"""

__version__ = "0.1.0"
