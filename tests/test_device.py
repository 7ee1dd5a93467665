"""pyflyt_tpu.device (the one module that looks at the platform), the
kernels' counter-hash normals, and the main path without flax/yaml/orbax."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyflyt_tpu import device
from pyflyt_tpu.ops import pallas_math as pmk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pallas_mode_by_backend(monkeypatch):
    assert device.pallas_interpret() is True  # the suite runs on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.pallas_interpret() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="neither"):
        device.pallas_interpret()


def test_require_gpu_never_falls_back_to_cpu():
    with pytest.raises(device.NoGpuError):
        device.require_gpu()


def test_describe_names_the_devices():
    d = device.describe()
    assert d["platform"] == "cpu" and d["count"] == len(jax.devices())
    assert isinstance(d["kind"], str) and isinstance(d["card"], str)


def test_compile_cache_placement():
    fixed = device.compile_cache_dir({})
    assert fixed == device.REPO_ROOT / ".jax_cache"
    assert device.compile_cache_dir({}) == fixed  # no pid/time in the path
    assert str(device.compile_cache_dir({device.CACHE_ENV: "/x/c"})) == "/x/c"


def test_enable_compile_cache_leaves_env_setting_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv(device.CACHE_ENV, "/somewhere")
    assert str(device.enable_compile_cache()) == "/somewhere"
    assert calls == []
    monkeypatch.delenv(device.CACHE_ENV)
    assert device.enable_compile_cache() == device.REPO_ROOT / ".jax_cache"
    assert calls == [("jax_compilation_cache_dir", str(device.REPO_ROOT / ".jax_cache"))]


def _draws(rows, lanes, seed, tile=pmk.TILE):
    packed = jnp.zeros((rows, pmk.SUBLANES, lanes), jnp.float32)
    kernel = lambda S, rng: [rng.normal() for _ in range(rows)]  # noqa: E731
    return pmk.grid_call(kernel, packed, jnp.int32(seed), tile)


def test_kernel_normals_equal_plain_reference():
    """Draw k of env e inside the kernel is the plain-jnp hash of
    (seed, e, k), for every program of the grid."""
    rows, lanes, seed = 3, 64, 77
    got = np.asarray(_draws(rows, lanes, seed))
    env = np.arange(pmk.SUBLANES * lanes, dtype=np.uint32).reshape(pmk.SUBLANES, lanes)
    env, s = jnp.asarray(env), jnp.uint32(seed)
    for k in range(rows):
        u1 = pmk.hash_uniform(s, env, 2 * k)
        u2 = pmk.hash_uniform(s, env, 2 * k + 1)
        want = jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * np.pi * u2)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-6, atol=1e-6)


def test_kernel_normals_independent_of_tiling():
    a = np.asarray(_draws(2, 32, 5, tile=16))
    b = np.asarray(_draws(2, 32, 5, tile=4))
    np.testing.assert_array_equal(a, b)


def test_hash_normal_moments():
    """Mean, variance, tails and cross-draw/cross-seed correlation of 2^17
    draws; bounds at 6 standard errors."""
    z = np.asarray(_draws(4, 4096, 1), np.float64).reshape(4, -1)
    n = z.size
    assert abs(z.mean()) < 6 / np.sqrt(n)
    assert abs(z.var() - 1.0) < 6 * np.sqrt(2.0 / n)
    assert abs(np.mean(np.abs(z) > 2.0) - 0.0455) < 6 * np.sqrt(0.0455 / n)
    c = np.corrcoef(z)[np.triu_indices(4, 1)]
    assert np.abs(c).max() < 6 / np.sqrt(z.shape[1])
    w = np.asarray(_draws(1, 4096, 2), np.float64).reshape(-1)
    assert abs(np.corrcoef(z[0], w)[0, 1]) < 6 / np.sqrt(w.size)
    u = np.asarray(pmk.hash_uniform(jnp.uint32(3), jnp.arange(n, dtype=jnp.uint32), 0))
    assert 0.0 < u.min() and u.max() < 1.0


def test_child_streams_are_independent():
    """Loop-iteration streams (HashNormal.child, indexed by a traced loop
    counter inside the kernels) are reproducible, distinct and uncorrelated
    with each other and with the parent stream."""
    packed = jnp.zeros((3, pmk.SUBLANES, 2048), jnp.float32)

    def kernel(S, rng):
        return [rng.normal(), rng.child(0).normal(), rng.child(jnp.int32(1)).normal()]

    z = np.asarray(pmk.grid_call(kernel, packed, jnp.int32(9)), np.float64)
    again = np.asarray(pmk.grid_call(kernel, packed, jnp.int32(9)), np.float64)
    np.testing.assert_array_equal(z, again)
    z = z.reshape(3, -1)
    c = np.corrcoef(z)[np.triu_indices(3, 1)]
    assert np.abs(c).max() < 6 / np.sqrt(z.shape[1])
    assert np.all(np.abs(z.std(axis=1) - 1.0) < 0.05)


def test_pow2_tile_choice():
    assert pmk._pow2_divisor(1024, 16) == 16
    assert pmk._pow2_divisor(24, 16) == 8
    assert pmk._pow2_divisor(3, 16) == 1


_BLOCKED = r"""
import sys
for name in ("flax", "yaml", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None
import jax, jax.numpy as jnp
import pyflyt_tpu.envs, pyflyt_tpu.rl
from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu.rl import PPO, PPOConfig, checkpoint
env = QuadXHoverEnv(max_duration_seconds=1.0)
st, obs = env.reset(jax.random.PRNGKey(0))
st, out = env.step(st, jnp.asarray([0.0, 0.0, 0.0, 0.36]))
assert bool(jnp.isfinite(out.reward))
ppo = PPO(env, PPOConfig(num_envs=8, rollout_steps=4, num_epochs=1,
                         num_minibatches=2, feature_sizes=(16,)))
runner = ppo.init(jax.random.PRNGKey(1))
runner, m = jax.jit(ppo.train_iteration)(runner)
assert bool(jnp.isfinite(m["loss"]))
path = checkpoint.save(sys.argv[1], runner)
back = checkpoint.restore(path, ppo.init(jax.random.PRNGKey(1)))
assert all(bool(jnp.all(a == b)) for a, b in
           zip(jax.tree.leaves(back), jax.tree.leaves(runner)))
assert all(sys.modules[n] is None for n in ("flax", "yaml", "orbax"))
print("BLOCKED-OK")
"""


def test_main_path_without_flax_yaml_orbax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BLOCKED-OK" in r.stdout


@pytest.mark.gpu
def test_fused_kernels_compiled_on_gpu(gpu):
    """Card-only: every fused kernel, compiled through Triton, against its
    XLA env on the GPU (chip_smoke.py's gates; skipped on the CPU)."""
    import chip_smoke

    for name in chip_smoke.KERNEL_GATES:
        chip_smoke.gate_kernel(name)
