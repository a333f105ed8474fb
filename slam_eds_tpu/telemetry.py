"""Structured runtime telemetry.

Replaces the reference's ad-hoc instrumentation (SURVEY §5: std::chrono
around ceres::Solve feeding ``TrackerInfo``/``PBAInfo`` structs,
src/tracking/Config.hpp:60-68 and src/bundles/Config.hpp:55-62, plus
[TRACKER]/[KEY_FRAME] stdout prefixes) with counters + wall-clock timers
that the bench and the recorder consume.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Telemetry:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    sums: dict = field(default_factory=lambda: defaultdict(float))
    _t0: dict = field(default_factory=dict)

    def tic(self, name: str):
        self._t0[name] = time.perf_counter()

    def toc(self, name: str):
        dt = time.perf_counter() - self._t0.pop(name)
        self.counters[f"{name}_n"] += 1
        self.sums[f"{name}_s"] += dt
        return dt

    def event_solve(self, n_iter: int, energy: float):
        """TrackerInfo equivalent (meas_time via tic/toc, iterations,
        success implicit in finite energy)."""
        self.counters["event_solves"] += 1
        self.counters["event_iters"] += n_iter
        self.sums["event_energy"] = energy

    def ba(self, energy: float):
        """PBAInfo equivalent."""
        self.counters["ba_runs"] += 1
        self.sums["ba_energy"] = energy

    def frame(self, ok: bool):
        self.counters["frames"] += 1
        if not ok:
            self.counters["track_failures"] += 1

    def rate(self, name: str):
        n = self.counters.get(f"{name}_n", 0)
        s = self.sums.get(f"{name}_s", 0.0)
        return n / s if s > 0 else 0.0

    def summary(self) -> dict:
        out = dict(self.counters)
        out.update({k: round(v, 6) for k, v in self.sums.items()})
        return out


class profile_trace:
    """Context manager around ``jax.profiler.trace`` — captures an XLA
    device trace (per-kernel timing) viewable in TensorBoard or Perfetto.
    The replacement for the reference's std::chrono
    spot timers (SURVEY §5 aux-subsystems note): the profiler attributes
    time to individual fused kernels instead of whole solver calls.

        with telemetry.profile_trace("/tmp/trace"):
            pipe.process_events(packet)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        import jax
        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        import jax
        jax.profiler.stop_trace()
        return False
