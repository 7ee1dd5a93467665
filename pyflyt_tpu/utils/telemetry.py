"""Throughput / real-time-factor telemetry + profiler hooks.

The reference's only perf instrumentation is the render-path RTF monitor
(wall-clock vs sim-time with a sleep lock, aviary.py:505-570). Equivalents
for the batched world:

- :class:`RTFMeter` — steps/sec + real-time factor for a vectorized run
  (RTF = simulated seconds per wall second, summed over the env batch).
- :func:`trace` — context manager around ``jax.profiler`` for capturing
  device traces viewable in TensorBoard/Perfetto (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import time


class RTFMeter:
    """Tracks env-steps/s and the aggregate real-time factor.

    >>> meter = RTFMeter(num_envs=8192, agent_hz=40)
    >>> meter.tick(steps=256)            # after each rollout chunk
    >>> meter.steps_per_s, meter.rtf
    """

    def __init__(self, num_envs: int, agent_hz: float):
        self.num_envs = num_envs
        self.agent_hz = agent_hz
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._env_steps = 0

    def tick(self, steps: int) -> None:
        """Records ``steps`` agent steps taken by every env in the batch."""
        self._env_steps += steps * self.num_envs

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_s(self) -> float:
        return self._env_steps / max(self.elapsed, 1e-9)

    @property
    def rtf(self) -> float:
        """Simulated seconds per wall second (aggregate over the batch).

        The reference displays per-sim RTF≈1 when rendering; a batch on
        the device runs many instances at once, so this aggregate is far
        above 1.
        """
        sim_seconds = self._env_steps / self.agent_hz
        return sim_seconds / max(self.elapsed, 1e-9)

    def summary(self) -> dict:
        return {
            "env_steps": self._env_steps,
            "steps_per_s": self.steps_per_s,
            "rtf": self.rtf,
            "elapsed_s": self.elapsed,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Captures a ``jax.profiler`` device trace around the body."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
