"""Smoke test of the main path on the GPU, in one process.

    python chip_smoke.py          # one GPU: env, kernels, trainer
    python chip_smoke.py --four   # four GPUs: data-parallel PPO vs one GPU

Phases (any failure raises; nothing is caught):

1. env: QuadXHoverEnv at 8192 envs, reset + a 512-step scan of the cached
   auto-reset step (bench.py's XLA path); rewards finite. Then 8 noise-free
   agent steps of 1024 envs on the GPU against the same program on the CPU.
   Tolerance 2e-4 absolute on obs and reward: both sides are float32 with
   the physics rotations pinned to full precision, so what differs is
   transcendental-function and fused-multiply-add rounding accumulated over
   8 agent steps, well under the obs's own scale (~1e-1).
2. kernels: every fused-kernel env at 8192 envs (4096 dogfight arenas),
   compiled through Triton (checked in the lowered program), against its
   XLA env on the GPU, noise off, for the first agent steps; the quadx
   kernel's mode 0/9 x ENU/NED envelope and its baked gaussian wind; the
   kernels' hash normals (moments, drawn by a kernel on the GPU); and a
   noisy run of the hover kernel (finite). Every noisy kernel shares the
   launcher and the hash, and each kernel costs a Triton compile of up to
   ~2 minutes, so the other noisy variants are covered by bench.py and the
   interpret-mode tests instead.
3. trainer: ``rl_training.hovering`` at the documented mode-9 recipe at
   full width for 3 updates with a best-model checkpoint, restored after.

``--four`` runs only the recipe's PPO iteration on a 4-GPU ``('env',)``
mesh and on one GPU, and compares the parameters after 3 updates.

It prints the card's name and power limit and, as the last line,
``{"ok": true, "device": {...}}``. With no GPU it exits nonzero first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu import device

# (name, atol per step, steps): tolerances of the fused-kernel parity gates.
# Noise off, float32 on both sides; the kernel evaluates the same equations
# in another order (hand-expanded rotations, fused reward/termination), so
# differences are rounding that grows with each step (hence atol * step).
# Hover keeps the tight 2e-4 of its gate; the fixedwing-family aero (atan2
# of small velocity ratios) and the rounded mod-hovering obs take the
# looser bounds their gates always used.
KERNEL_GATES = {
    "quadx_hover": (2e-4, 3),
    "quadx_waypoints": (1e-3, 4),
    "quadx_mod_hovering": (2e-3, 4),
    "fixedwing_waypoints": (1e-3, 4),
    "rocket_landing": (1e-3, 4),
    "dogfight": (2e-3, 4),
}
# At 8192 instances a rounding-level difference can still cross a threshold
# for a few envs: mod hovering rounds its state to 3 decimals before
# normalizing (one flip moves an obs entry by 2e-3 / range), and contact or
# termination tests are comparisons. So each gate lets at most 0.1% of the
# envs differ (reported as ``lanes_off``); every other env must match within
# the tolerance, with identical termination.
LANE_ALLOWANCE = 1e-3
N = 8192
TRITON_CALL = "__gpu$xla.gpu.triton"


def log(**fields):
    print(json.dumps(fields), flush=True)


def assert_close(got, want, atol, what, rtol=0.0):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)


def lanes_off(got, want, atol, rtol=0.0):
    """Per instance (leading axis): True where any element of any leaf is
    outside ``atol + rtol * |want|``."""
    off = None
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        bad = np.abs(g - w) > atol + rtol * np.abs(w)
        bad = bad.reshape(bad.shape[0], -1).any(axis=1)
        off = bad if off is None else off | bad
    return off


def assert_lanes(off, what):
    n_off, n = int(off.sum()), off.shape[0]
    assert n_off <= LANE_ALLOWANCE * n, f"{what}: {n_off} of {n} instances off"
    return n_off


# ---------------------------------------------------------------- phase 1
def phase_env():
    import bench
    from pyflyt_tpu.envs.base import vec_reset
    from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv

    run, agent_steps = bench.make_run("quadx_hover", fused=False)
    t0 = time.perf_counter()
    total = float(run(jax.random.PRNGKey(0)))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    total = float(run(jax.random.PRNGKey(1)))
    dt = time.perf_counter() - t0
    assert np.isfinite(total), total
    log(phase="env", num_envs=N, steps=bench.STEPS, reward_sum=total,
        first_call_s=first, seconds=dt, env_steps_per_s=agent_steps / dt)

    env = QuadXHoverEnv(noisy_motors=False)
    n = 1024
    act = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.42]), (n, 1))

    @jax.jit
    def eight_steps(keys, act):
        st, _ = vec_reset(env, keys)

        def body(st, _):
            st, out = jax.vmap(env.step)(st, act)
            return st, (out.obs, out.reward)

        return jax.lax.scan(body, st, None, length=8)[1]

    keys = jax.random.split(jax.random.PRNGKey(3), n)
    gpu = eight_steps(keys, act)
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = eight_steps(jax.device_put(keys, cpu_dev), jax.device_put(act, cpu_dev))
    diff = max(float(np.max(np.abs(np.asarray(g) - np.asarray(c))))
               for g, c in zip(gpu, cpu))
    assert_close(gpu, cpu, 2e-4, "GPU vs CPU XLA hover env (obs, reward)")
    log(phase="env-gpu-vs-cpu", num_envs=n, steps=8, max_abs_diff=diff,
        atol=2e-4)


# ---------------------------------------------------------------- phase 2
def _pair(name, noisy):
    """(xla_env, packed_env, action, n_instances) for the parity gate."""
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

    if name == "quadx_hover":
        e = QuadXHoverEnv(noisy_motors=noisy)
        return e, PackedQuadXHoverEnv(base=e), [0.0, 0.0, 0.0, 0.42], N
    if name == "quadx_waypoints":
        e = QuadXWaypointsEnv(noisy_motors=noisy, flight_mode=7)
        return e, PackedQuadXWaypointsEnv(base=e), [0.5, 0.5, 0.0, 1.0], N
    if name == "quadx_mod_hovering":
        e = QuadXModHoveringEnv(
            flight_mode=9, orn_conv="NED_FRD", control_hz=80,
            noisy_motors=noisy, simulate_wind=True,
            max_gust_strength=7.0 if noisy else 0.0,
        )
        return e, PackedQuadXModHoveringEnv(base=e), [0.0] * 4, N
    if name == "fixedwing_waypoints":
        e = FixedwingWaypointsEnv(noisy_motors=noisy)
        return (e, PackedFixedwingWaypointsEnv(base=e),
                [0.0, 0.05, 0.0, 0.7], N)
    if name == "rocket_landing":
        e = RocketLandingEnv(noisy_boosters=noisy)
        return (e, PackedRocketLandingEnv(base=e),
                [0.0, 0.0, 0.0, 1.0, 0.5, 0.0, 0.0], N)
    if name == "dogfight":
        e = MAFixedwingDogfightEnv(noisy_motors=noisy)
        return e, PackedMAFixedwingDogfightEnv(base=e), [0.0, 0.0, 0.0, 0.8], N // 2
    raise KeyError(name)


def gate_kernel(name):
    atol, steps = KERNEL_GATES[name]
    xla_env, packed, center, n = _pair(name, noisy=False)
    shape = (n, 2, len(center)) if name == "dogfight" else (n, len(center))
    act = jnp.broadcast_to(jnp.asarray(center), shape)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    ref_st, _ = jax.jit(jax.vmap(xla_env.reset))(keys)
    pk_st, _ = jax.jit(packed.reset)(keys)
    ref_step = jax.jit(jax.vmap(xla_env.step))
    pk_step = jax.jit(packed.step)
    hlo = pk_step.lower(pk_st, act).as_text()
    assert TRITON_CALL in hlo, f"{name}: the kernel did not lower to Triton"
    worst, most_off = 0.0, 0
    for i in range(steps):
        ref_st, ref_out = ref_step(ref_st, act)
        pk_st, out = pk_step(pk_st, act)
        tol = atol * (i + 1)
        off = lanes_off(out.obs, ref_out.obs, tol) | lanes_off(
            out.reward, ref_out.reward, tol, rtol=1e-3
        )
        term = np.asarray(out.termination) != np.asarray(ref_out.termination)
        off = off | term.reshape(term.shape[0], -1).any(axis=1)
        most_off = max(most_off, assert_lanes(off, f"{name} step {i}"))
        worst = max(worst, max(
            float(np.max(np.abs(np.asarray(g) - np.asarray(w))[~off]))
            for g, w in zip(jax.tree.leaves(out.obs), jax.tree.leaves(ref_out.obs))
        ))
    log(phase="kernel-parity", env=name, instances=n, steps=steps,
        max_abs_obs_diff_in_tolerance=worst, atol_per_step=atol,
        lanes_off=most_off, triton=True)


def gate_quadx_envelope():
    """The quadx kernel beyond the fused envs: modes 0/9 in ENU and NED, and
    a baked deterministic gaussian wind, against models/quadx.py."""
    from pyflyt_tpu.models import quadx
    from pyflyt_tpu.ops import pallas_quadx

    key = jax.random.PRNGKey(12)

    def spawn(cfg, params, z, seed=12):
        k = jax.random.PRNGKey(seed)
        pos = jax.random.uniform(k, (N, 3), minval=-2, maxval=2) + jnp.asarray(
            [0.0, 0.0, z]
        )
        orn = jax.random.uniform(
            jax.random.fold_in(k, 1), (N, 3), minval=-0.3, maxval=0.3
        )
        st = quadx.init_state(params, cfg, pos, orn)
        return st.replace(read=quadx.update_state(st.body, cfg))

    def run(cfg, params, st, mode, iters, wind_fn=None, wind=None):
        ref_step = jax.jit(lambda s: quadx.step(s, params, cfg, mode, wind_fn=wind_fn))
        krn_step = jax.jit(lambda s: pallas_quadx.step(s, params, cfg, mode, wind=wind))
        ref = out = st
        for _ in range(iters):
            ref, _ = ref_step(ref)
            out, _ = krn_step(out)
        return ref, out

    for orn_conv, z in (("ENU_FLU", 5.0), ("NED_FRD", -5.0)):
        for mode in (0, 9):
            cfg = quadx.QuadXConfig(noisy_motors=False, orn_conv=orn_conv)
            params = quadx.build_params(cfg)
            st = quadx.set_mode(spawn(cfg, params, z), mode, cfg)
            neg = -1.0 if orn_conv == "NED_FRD" else 1.0
            if mode == 0:
                sp = jax.random.uniform(key, (N, 4), minval=-0.3, maxval=0.3)
                sp = sp.at[:, 3].set(0.4 * neg)
            else:
                sp = jax.random.uniform(key, (N, 4), minval=-0.05, maxval=0.05)
                sp = sp.at[:, 3].set(0.4)
            ref, out = run(cfg, params, st.replace(setpoint=sp), mode, 8)
            off = lanes_off(out.body.pos, ref.body.pos, 1e-4) | lanes_off(
                out.read.view, ref.read.view, 2e-4
            )
            n_off = assert_lanes(off, f"{orn_conv} mode {mode}")
            log(phase="kernel-envelope", case=f"mode{mode}-{orn_conv}",
                lanes_off=n_off)

    cfg = quadx.QuadXConfig(noisy_motors=False)
    params = quadx.build_params(cfg)
    st = quadx.set_mode(spawn(cfg, params, 5.0, seed=5), 0, cfg)
    st = st.replace(setpoint=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.42]), (N, 1)))
    base = (3.0, -1.5, 0.5)
    wind_fn = lambda step, p: jnp.broadcast_to(jnp.asarray(base, p.dtype), p.shape)  # noqa: E731
    ref, out = run(cfg, params, st, 0, 12, wind_fn=wind_fn,
                   wind={"kind": "gaussian", "base": base, "max_gust": 0.0})
    n_off = assert_lanes(lanes_off(out.body.pos, ref.body.pos, 5e-4),
                         "gaussian wind")
    log(phase="kernel-envelope", case="gaussian-wind", lanes_off=n_off)


def gate_hash_normals():
    """Moments of the kernels' counter-hash normals, drawn on the GPU:
    16 draws x 2^20 envs. Bounds are 6 standard errors (mean: 1/sqrt(n);
    variance: sqrt(2/n)); rows must also be uncorrelated."""
    from pyflyt_tpu.ops import pallas_math as pmk

    rows, lanes = 16, 2**17
    packed = jnp.zeros((rows, pmk.SUBLANES, lanes), jnp.float32)
    z = jax.jit(lambda p, s: pmk.grid_call(
        lambda S, rng: [rng.normal() for _ in range(rows)], p, s
    ))(packed, jnp.int32(1234))
    z = np.asarray(z, np.float64).reshape(rows, -1)
    n = z.size
    mean, var = float(z.mean()), float(z.var())
    corr = float(np.corrcoef(z)[np.triu_indices(rows, 1)].__abs__().max())
    assert abs(mean) < 6 / np.sqrt(n), mean
    assert abs(var - 1.0) < 6 * np.sqrt(2.0 / n), var
    assert corr < 6 / np.sqrt(z.shape[1]), corr
    log(phase="hash-normals", draws=n, mean=mean, var=var, max_row_corr=corr)


def noisy_run(name):
    _, packed, center, n = _pair(name, noisy=True)
    shape = (n, 2, len(center)) if name == "dogfight" else (n, len(center))
    act = jnp.broadcast_to(jnp.asarray(center), shape)
    st, _ = jax.jit(packed.reset)(jax.random.split(jax.random.PRNGKey(9), n))
    step = jax.jit(packed.step)
    for _ in range(8):
        st, out = step(st, act)
    for leaf in jax.tree.leaves((out.obs, out.reward)):
        assert np.all(np.isfinite(np.asarray(leaf))), f"{name}: non-finite"
    log(phase="kernel-noisy", env=name, steps=8, finite=True)


def phase_kernels():
    assert not device.pallas_interpret()
    for name in KERNEL_GATES:
        gate_kernel(name)
    gate_quadx_envelope()
    gate_hash_normals()
    noisy_run("quadx_hover")


# ---------------------------------------------------------------- phase 3
MODE9 = [
    "--flight_mode", "9", "--num_envs", "2048", "--rollout_steps", "128",
    "--n_epochs", "10", "--num_minibatches", "64", "--learning_rate", "1e-4",
    "--clip_eps", "0.1", "--init_log_std", "-1.6",
    "--num_of_layers", "2", "--layer_size", "256",
    "--total_timesteps", str(3 * 2048 * 128),
]


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def train_mode9(extra):
    """Runs the mode-9 recipe through the CLI; returns (runner, rows)."""
    from pyflyt_tpu.rl_training import hovering

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        runner = hovering.main(["train", *MODE9, *extra])
    seconds = time.perf_counter() - t0
    rows = [json.loads(x) for x in "".join(tee.lines).splitlines()
            if x.startswith("{")]
    assert rows and all(np.isfinite(r["loss"]) for r in rows), rows
    return runner, rows, seconds


def _template():
    return _mode9_ppo().init(jax.random.PRNGKey(0))  # the seed train() uses


def _max_abs(a, b):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def phase_trainer():
    from pyflyt_tpu.rl import checkpoint

    log_dir = os.path.join(device.REPO_ROOT, "runs", "chip_smoke")
    shutil.rmtree(log_dir, ignore_errors=True)
    runner, rows, seconds = train_mode9(["--log_dir", log_dir])
    ckpts = [f for f in os.listdir(log_dir) if f.startswith("best_model_")]
    assert ckpts, os.listdir(log_dir)
    template = _template()
    restored = checkpoint.restore(os.path.join(log_dir, sorted(ckpts)[-1]), template)
    moved = _max_abs(restored.params, template.params)
    assert moved > 0.0, "params did not change"
    assert _max_abs(restored.params, runner.params) == 0.0
    log(phase="trainer", updates=rows[-1]["update"], loss=rows[-1]["loss"],
        steps_per_s=rows[-1]["steps_per_s"], seconds_with_compile=seconds,
        checkpoint=sorted(ckpts)[-1], params_moved=moved, restored=True)


def _mode9_ppo():
    from pyflyt_tpu.rl import PPO, PPOConfig
    from pyflyt_tpu.rl_training import hovering

    p = argparse.ArgumentParser()
    hovering.add_env_args(p)
    env_args, _ = p.parse_known_args(MODE9)
    return PPO(hovering.build_env(env_args), PPOConfig(
        num_envs=2048, rollout_steps=128, num_epochs=10, num_minibatches=64,
        learning_rate=1e-4, clip_eps=0.1, init_log_std=-1.6,
        feature_sizes=(256, 256),
    ))


def phase_four():
    """The recipe's PPO iteration on a 4-GPU ('env',) mesh — the path
    ``TrainConfig(use_mesh=True)`` takes: ``parallel.env_mesh`` +
    ``PPO.shard_runner`` — against the same 3 updates on one GPU. Gradient
    all-reduce order differs, so params agree to a tolerance: the
    mesh/single difference must be under 5% of how far training moved the
    params (max-abs over every leaf)."""
    from pyflyt_tpu.parallel import env_mesh

    assert len(jax.devices()) == 4, jax.devices()
    ppo = _mode9_ppo()
    init = ppo.init(jax.random.PRNGKey(0))
    init_params = jax.tree.map(np.asarray, init.params)
    # the jit rl/train.py builds, so the one-GPU program is the trainer's
    step = jax.jit(ppo.train_iteration, donate_argnums=(0,))
    out = {}
    for name, runner in (
        ("mesh", ppo.shard_runner(jax.tree.map(jnp.copy, init), env_mesh())),
        ("one", jax.tree.map(jnp.copy, init)),
    ):
        t0 = time.perf_counter()
        runner, m = step(runner)
        jax.block_until_ready(runner.params)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(2):
            runner, m = step(runner)
        jax.block_until_ready(runner.params)
        dt = (time.perf_counter() - t0) / 2
        assert np.isfinite(float(m["loss"])), m
        out[name] = (runner.params, float(m["loss"]), first, dt)
    diff = _max_abs(out["mesh"][0], out["one"][0])
    moved = _max_abs(out["one"][0], init_params)
    log(phase="four-gpu-mesh", updates=3, max_abs_param_diff=diff,
        params_moved=moved, ratio=diff / moved,
        mesh_loss=out["mesh"][1], one_loss=out["one"][1],
        mesh_first_update_s=out["mesh"][2], one_first_update_s=out["one"][2],
        mesh_update_s=out["mesh"][3], one_update_s=out["one"][3],
        env_steps_per_update=ppo.config.batch_size)
    assert diff <= 0.05 * moved, (diff, moved)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the 4-GPU data-parallel phase and its 1-GPU twin")
    args = p.parse_args(argv)
    device.require_gpu()
    device.enable_compile_cache()
    print(device.card_name_and_power_limit(), flush=True)
    if args.four:
        phase_four()
    else:
        phase_env()
        phase_kernels()
        phase_trainer()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
