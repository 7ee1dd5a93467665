"""The one place that looks at the platform JAX runs on.

- ``describe()`` names the devices and the card (``nvidia-smi``'s name and
  power limit), for every line a measurement prints.
- ``pallas_interpret()`` decides how a Pallas kernel runs: compiled through
  Triton on a GPU, interpreted on the CPU (tests and CPU scripts), and
  nowhere else.
- ``require_gpu()`` is what a measurement calls first: it raises when JAX
  finds no GPU and never falls back to the CPU.
- ``enable_compile_cache()`` places JAX's persistent compilation cache.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parent.parent
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


class NoGpuError(RuntimeError):
    """JAX found no GPU where one was required."""


def pallas_interpret() -> bool:
    """True when Pallas kernels must run in interpret mode (CPU backend),
    False when they compile through Triton (GPU backend)."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"Pallas kernels compile for a GPU (Triton) or run interpreted on "
        f"the CPU; the {platform!r} backend is neither"
    )


def require_gpu() -> list:
    """The GPU devices; raises ``NoGpuError`` if there are none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError as e:
        raise NoGpuError(f"no GPU found by JAX: {e}") from e
    if jax.default_backend() != "gpu":
        raise NoGpuError(
            f"JAX's default backend is {jax.default_backend()!r}, not 'gpu'"
        )
    return devices


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card), or a note that it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def describe() -> dict:
    """Platform, device kind, device count and the card's name/power limit."""
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
        "card": card_name_and_power_limit(),
    }


def compile_cache_dir(environ=None) -> Path:
    """Where the persistent compilation cache lives: ``$JAX_COMPILATION_CACHE_DIR``
    when set (in ``environ``, default ``os.environ``), else a fixed directory
    inside the checkout (a path that moves between runs would never hit)."""
    env = (os.environ if environ is None else environ).get(CACHE_ENV)
    return Path(env) if env else REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> Path:
    """Turns the persistent compilation cache on. When the environment names
    a directory JAX already reads it, so nothing is set here."""
    path = compile_cache_dir()
    if CACHE_ENV not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
