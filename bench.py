"""Env-stepping throughput on one GPU: fused-kernel envs and their XLA twins.

    python bench.py          # QuadX-Hover: the XLA env and the fused kernel
    python bench.py --all    # every fused-kernel env beside its XLA twin

Each measurement is one jitted program: reset of ``NUM_ENVS`` envs, then a
``STEPS``-step ``lax.scan`` with random actions around a fixed action. Envs
with a cached auto-reset path run it on both sides (refresh period
``REFRESH``); the others step without resets on both sides (finished envs
stay frozen in both, so both do the same work). Compilation is timed apart;
the reported time is the median of ``REPEATS`` timed runs with fresh keys.

Prints one JSON line per measurement with the platform, device kind, device
count and the card's name and power limit. With no GPU it prints one JSON
error line and exits 1: there is no CPU number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp

from pyflyt_tpu import device

NUM_ENVS = 8192
STEPS = 512
REFRESH = 64
REPEATS = 3


def _workloads():
    """name -> (xla_env, packed_env, action_center, kind). ``kind`` is
    "cached" (cached auto-reset on both sides) or "step" (plain steps)."""
    from pyflyt_tpu.envs.fixedwing_waypoints import FixedwingWaypointsEnv
    from pyflyt_tpu.envs.ma_fixedwing_dogfight import MAFixedwingDogfightEnv
    from pyflyt_tpu.envs.packed_dogfight import PackedMAFixedwingDogfightEnv
    from pyflyt_tpu.envs.packed_fixedwing_waypoints import (
        PackedFixedwingWaypointsEnv,
    )
    from pyflyt_tpu.envs.packed_hover import PackedQuadXHoverEnv
    from pyflyt_tpu.envs.packed_quadx_waypoints import PackedQuadXWaypointsEnv
    from pyflyt_tpu.envs.packed_rocket_landing import PackedRocketLandingEnv
    from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu.envs.quadx_mod.hovering import QuadXModHoveringEnv
    from pyflyt_tpu.envs.quadx_mod.packed_hovering import (
        PackedQuadXModHoveringEnv,
    )
    from pyflyt_tpu.envs.quadx_waypoints import QuadXWaypointsEnv
    from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv

    hover_t = float(jnp.sqrt(0.027 * 9.81 / 2.0))
    hover = QuadXHoverEnv()
    qwp = QuadXWaypointsEnv()
    mod = QuadXModHoveringEnv(flight_mode=9)
    fw = FixedwingWaypointsEnv()
    rk = RocketLandingEnv()
    dog = MAFixedwingDogfightEnv()
    return {
        "quadx_hover": (hover, PackedQuadXHoverEnv(base=hover),
                        [0.0, 0.0, 0.0, hover_t], "cached"),
        "quadx_waypoints": (qwp, PackedQuadXWaypointsEnv(base=qwp),
                            [0.0, 0.0, 0.0, hover_t], "step"),
        "quadx_mod_hovering": (mod, PackedQuadXModHoveringEnv(base=mod),
                               [0.0, 0.0, 0.0, 0.0], "cached"),
        "fixedwing_waypoints": (fw, PackedFixedwingWaypointsEnv(base=fw),
                                [0.0] * fw.action_size, "step"),
        "rocket_landing": (rk, PackedRocketLandingEnv(base=rk),
                           [0.0] * 6 + [0.5], "step"),
        "dogfight": (dog, PackedMAFixedwingDogfightEnv(base=dog),
                     [0.0, 0.0, 0.0, 0.7], "step"),
    }


def _actions(key, center, n, agents):
    shape = (n, agents, len(center)) if agents else (n, len(center))
    return jnp.asarray(center) + 0.1 * jax.random.normal(key, shape)


def make_run(name: str, fused: bool, n: int = NUM_ENVS, steps: int = STEPS):
    """The jitted ``key -> reward sum`` program of one measurement, and the
    number of agent-steps it takes."""
    from pyflyt_tpu.envs.base import autoreset_init, cached_autoreset_step
    from pyflyt_tpu.envs.packed_hover import (
        PackedQuadXHoverEnv,
        packed_autoreset_init,
        packed_cached_autoreset_step,
    )

    xla_env, packed_env, center, kind = _workloads()[name]
    agents = 2 if name == "dogfight" else 0
    n_inst = n // 2 if agents else n  # dogfight: n agents = n/2 arenas

    if kind == "cached" and fused and isinstance(packed_env, PackedQuadXHoverEnv):
        init = lambda k: packed_autoreset_init(packed_env, k)[0]
        step = lambda s, a: packed_cached_autoreset_step(packed_env, s, a, REFRESH)
    elif kind == "cached" and fused:
        init = lambda k: packed_env.cached_autoreset_init(k)[0]
        step = lambda s, a: packed_env.cached_autoreset_step(s, a, REFRESH)
    elif kind == "cached":
        init = lambda k: autoreset_init(xla_env, k)[0]
        step = lambda s, a: cached_autoreset_step(xla_env, s, a, REFRESH)
    elif fused:
        init = lambda k: packed_env.reset(k)[0]
        step = packed_env.step
    else:
        init = lambda k: jax.vmap(xla_env.reset)(k)[0]
        step = jax.vmap(xla_env.step)

    @jax.jit
    def run(key):
        k_reset, k_act = jax.random.split(key)
        state = init(jax.random.split(k_reset, n_inst))

        def body(carry, k):
            st, total = carry
            st, out = step(st, _actions(k, center, n_inst, agents))
            return (st, total + jnp.sum(out.reward)), None

        (_, total), _ = jax.lax.scan(
            body, (state, jnp.zeros(())), jax.random.split(k_act, steps)
        )
        return total

    return run, n * steps


def measure(name: str, fused: bool, info: dict) -> dict:
    run, agent_steps = make_run(name, fused)
    t0 = time.perf_counter()
    total = float(run(jax.random.PRNGKey(0)))
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.PRNGKey(i + 1)))
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    return {
        "metric": f"{name} {'fused kernel' if fused else 'XLA'} agent-steps/s",
        "value": agent_steps / t,
        "unit": "agent-steps/s",
        "num_envs": NUM_ENVS,
        "steps": STEPS,
        "seconds": t,
        "seconds_all": times,
        "first_call_s": compile_s,
        "reward_finite": bool(jnp.isfinite(total)),
        **info,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--all", action="store_true",
                   help="every fused-kernel env beside its XLA twin")
    args = p.parse_args(argv)
    try:
        device.require_gpu()
    except device.NoGpuError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    device.enable_compile_cache()
    info = device.describe()
    names = list(_workloads()) if args.all else ["quadx_hover"]
    for name in names:
        for fused in (False, True):
            print(json.dumps(measure(name, fused, info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
