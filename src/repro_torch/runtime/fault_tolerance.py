"""Fault-tolerance runtime — the port of ``repro/runtime/fault_tolerance.py``
(host code; only imports and docstrings differ from the reference):
heartbeats, straggler detection, failure injection and the remesh plan.

The state machines run in-process:
  · HeartbeatRegistry: workers check in; silence > timeout => failure
  · StragglerDetector: per-host step-time z-score (robust MAD) => slow host
  · FailureInjector  : deterministic fault schedule for drills
  · plan_remesh      : failed hosts => next viable (data, model) mesh shape

Each state machine takes an optional ``metrics`` MetricsRegistry
(runtime/telemetry.py) and emits ``ft/*`` counters — heartbeats, straggler
flags, injected faults — so ``--fault-rate`` drills show up in the serve
metrics snapshot.  Telemetry never changes any decision these classes make.
"""
from __future__ import annotations

import time
from collections.abc import Sequence
from dataclasses import dataclass, field

import numpy as np


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 30.0, clock=time.monotonic, *,
                 metrics=None):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: dict[str, float] = {}
        self.metrics = metrics

    def beat(self, worker: str):
        self._last[worker] = self._clock()
        if self.metrics is not None:
            self.metrics.inc("ft/heartbeats")

    def alive(self) -> list[str]:
        now = self._clock()
        return [w for w, t in self._last.items() if now - t <= self.timeout_s]

    def dead(self) -> list[str]:
        now = self._clock()
        return [w for w, t in self._last.items() if now - t > self.timeout_s]


class StragglerDetector:
    """Flags hosts whose step time exceeds median + z·MAD over a window."""

    def __init__(self, window: int = 16, z: float = 4.0, *, metrics=None):
        self.window = window
        self.z = z
        self._times: dict[str, list[float]] = {}
        self.metrics = metrics

    def record(self, worker: str, step_time_s: float):
        buf = self._times.setdefault(worker, [])
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)
        if self.metrics is not None:
            self.metrics.inc("ft/step_samples")
            self.metrics.observe(f"ft/step_ms/{worker}",
                                 step_time_s * 1e3)

    def stragglers(self) -> list[str]:
        if len(self._times) < 2:
            return []
        med_per = {w: float(np.median(t)) for w, t in self._times.items()
                   if len(t) >= 4}
        if len(med_per) < 2:
            return []
        meds = np.array(list(med_per.values()))
        med = float(np.median(meds))
        mad = float(np.median(np.abs(meds - med))) + 1e-9
        out = [w for w, m in med_per.items()
               if (m - med) / (1.4826 * mad) > self.z]
        if self.metrics is not None and out:
            self.metrics.inc("ft/straggler_flags", len(out))
        return out


@dataclass
class FailureInjector:
    """Deterministic fault schedule: raise WorkerFailure at given steps."""
    fail_at_steps: Sequence[int] = field(default_factory=tuple)
    metrics: object = None

    def check(self, step: int):
        if step in self.fail_at_steps:
            if self.metrics is not None:
                self.metrics.inc("ft/injected_faults")
            raise WorkerFailure(f"injected failure at step {step}")

    @classmethod
    def from_rate(cls, rate: float, horizon: int = 100_000, *,
                  metrics=None):
        """Schedule matching a mean failure RATE (failures per step): one
        failure every round(1/rate) steps out to `horizon`.  Periodic, not
        sampled — the serve loop's --fault-rate drills must be replayable
        bit-for-bit, and a deterministic schedule is what lets the test
        assert the faulted run's outputs against the unfaulted run's."""
        assert 0 < rate <= 1, f"rate must be in (0, 1], got {rate}"
        period = max(1, round(1.0 / rate))
        return cls(fail_at_steps=frozenset(range(period, horizon, period)),
                   metrics=metrics)


class WorkerFailure(RuntimeError):
    pass


def plan_remesh(n_alive_hosts: int, chips_per_host: int,
                model_parallel: int) -> tuple | None:
    """Largest (data, model) mesh that fits the surviving chips with the
    required model-parallel degree; None if impossible. Elastic scale-down
    keeps TP intact and shrinks the data axis (checkpoint reshard-on-load
    handles the rest — see checkpoint.restore)."""
    chips = n_alive_hosts * chips_per_host
    if chips < model_parallel:
        return None
    data = chips // model_parallel
    # power-of-two data axis keeps batch divisibility predictable
    data = 1 << (data.bit_length() - 1)
    return (data, model_parallel)
