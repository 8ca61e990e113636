"""Zero-dependency serving telemetry core (DESIGN.md §15).

Three primitives, stdlib-only so they import (and stay cheap) everywhere
in the runtime — kernels, scheduler, pool, serve loop:

  MetricsRegistry   process-wide counters / gauges / log-bucketed
                    histograms.  Replaces the ad-hoc stat dicts and the
                    duplicated percentile math that used to live in
                    runtime/scheduler.py and launch/serve.py: every
                    subsystem writes named instruments into one registry
                    and the serve summary / ``--metrics-out`` render from
                    ONE snapshot.

  Tracer            per-request lifecycle + per-launch span events in a
                    BOUNDED ring buffer (overflow drops the oldest event,
                    never grows), exported as Chrome trace-event JSON
                    (``--trace-out``, loadable in Perfetto / chrome
                    about:tracing).

  KernelProfiler    opt-in per-launch attention-kernel timing hook.
                    ``core.attn_spec.attn_entry`` — the single choke
                    point every public attention entry goes through —
                    consults :func:`profiler` and, when one is installed,
                    times the launch between two device syncs and tags
                    it with the AttnSpec + argument geometry.  The
                    roofline join lives in ``launch/obs.py``.

Histogram contract (the part tests pin): values are QUANTIZED at record
time onto log-spaced buckets (geometric midpoint representative, relative
error <= ``rel_err``); ``merge`` is plain bucket-count addition, so it is
exactly associative and commutative; ``percentile`` is the EXACT
nearest-rank percentile of the quantized multiset.  Deterministic,
mergeable, bounded-memory — the properties the scheduler's per-class
latency tails and CI-archived snapshots need.

The telemetry invariant (enforced by tests + BENCH_obs.json): recording
never influences served tokens — telemetry-on output is bitwise identical
to telemetry-off — and the default-sampling overhead stays <= 2% of
decode throughput.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from contextlib import contextmanager

# version stamp for --metrics-out / --trace-out consumers; bump on any
# field reshape so CI archives are never silently misread
OBS_SCHEMA_VERSION = 1


# ---------------------------------------------------------------- metrics
class Counter:
    """Monotone event count.  ``incs`` tracks the number of ``inc`` calls
    (not the value) — the overhead-accounting input for BENCH_obs."""
    __slots__ = ("value", "incs")

    def __init__(self):
        self.value = 0
        self.incs = 0

    def inc(self, n: int = 1) -> None:
        self.value += n
        self.incs += 1


class Gauge:
    """Last-set value (pool occupancy, queue depth, ...)."""
    __slots__ = ("value", "sets")

    def __init__(self):
        self.value = 0.0
        self.sets = 0

    def set(self, v) -> None:
        self.value = float(v)
        self.sets += 1


class Histogram:
    """Mergeable log-bucketed histogram with exact quantized percentiles.

    Record-time quantization: value ``v > 0`` lands in bucket
    ``i = floor(log(v) / log(gamma))`` with ``gamma = (1+rel_err)/(1-rel_err)``
    and reads back as the geometric bucket midpoint ``gamma**(i+0.5)`` —
    relative error at most ``sqrt(gamma) - 1`` (~``rel_err``).  Values
    ``<= 0`` land in a dedicated zero bucket reading back as ``0.0``.

    All state is integer bucket counts plus exact float min/max, so
    ``merge`` (bucket-wise addition) is exactly associative/commutative
    and a merged histogram's percentiles equal the percentiles of the
    concatenated sample streams — the property tests/test_telemetry.py
    drives.  ``sum``/``mean`` are derived from the quantized counts (same
    ~rel_err contract)."""
    __slots__ = ("rel_err", "_gamma", "_lg", "counts", "zero", "vmin",
                 "vmax")

    def __init__(self, rel_err: float = 0.01):
        assert 0 < rel_err < 1, f"rel_err must be in (0, 1), got {rel_err}"
        self.rel_err = rel_err
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self._gamma)
        self.counts: dict[int, int] = {}
        self.zero = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    @classmethod
    def from_values(cls, values, rel_err: float = 0.01) -> "Histogram":
        h = cls(rel_err)
        for v in values:
            h.record(v)
        return h

    def record(self, v) -> None:
        v = float(v)
        if v <= 0.0:
            self.zero += 1
            v = 0.0
        else:
            i = math.floor(math.log(v) / self._lg)
            self.counts[i] = self.counts.get(i, 0) + 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def _rep(self, i: int) -> float:
        return self._gamma ** (i + 0.5)

    @property
    def count(self) -> int:
        return self.zero + sum(self.counts.values())

    @property
    def sum(self) -> float:
        # derived from counts in sorted-bucket order: deterministic for a
        # given bucket multiset, so merged histograms agree bit-for-bit
        return math.fsum(n * self._rep(i)
                         for i, n in sorted(self.counts.items()))

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile of the quantized multiset:
        the smallest recorded (quantized) value with cumulative count
        >= ceil(q/100 * n).  0.0 on an empty histogram."""
        n = self.count
        if n == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * n))
        if rank <= self.zero:
            return 0.0
        acc = self.zero
        for i, c in sorted(self.counts.items()):
            acc += c
            if acc >= rank:
                return self._rep(i)
        return self._rep(max(self.counts))          # q > 100 clamps to max

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-count addition into a NEW histogram (operands
        untouched).  Exactly associative and commutative: every field is
        either an integer sum or a min/max."""
        assert self.rel_err == other.rel_err, \
            f"histogram resolution mismatch: {self.rel_err} vs {other.rel_err}"
        out = Histogram(self.rel_err)
        out.counts = dict(self.counts)
        for i, c in other.counts.items():
            out.counts[i] = out.counts.get(i, 0) + c
        out.zero = self.zero + other.zero
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        return out

    def to_dict(self) -> dict:
        n = self.count
        return {"count": n, "sum": self.sum,
                "min": self.vmin if n else 0.0,
                "max": self.vmax if n else 0.0,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99), "rel_err": self.rel_err}


class MetricsRegistry:
    """Named instrument store: ``counter``/``gauge``/``histogram`` are
    create-or-get (a name maps to exactly one instrument kind — reusing a
    name across kinds is a bug and asserts).  ``snapshot()`` is the one
    read path the serve summary, ``--metrics-out`` and the tests share.

    Single-threaded by design (the serve loop is one thread); no locks."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def _fresh(self, name: str, table: dict) -> None:
        for other in (self._counters, self._gauges, self._hists):
            assert other is table or name not in other, \
                f"metric {name!r} already registered as another kind"

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._fresh(name, self._counters)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._fresh(name, self._gauges)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, rel_err: float = 0.01) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            self._fresh(name, self._hists)
            h = self._hists[name] = Histogram(rel_err)
        return h

    # conveniences for cold paths (hot loops hold the instrument object)
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def observe(self, name: str, v) -> None:
        self.histogram(name).record(v)

    def value(self, name: str):
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            return self._gauges[name].value
        raise KeyError(name)

    def op_count(self) -> int:
        """Total recording operations since construction — the
        numerator of the BENCH_obs overhead accounting."""
        return (sum(c.incs for c in self._counters.values())
                + sum(g.sets for g in self._gauges.values())
                + sum(h.count for h in self._hists.values()))

    def snapshot(self) -> dict:
        """One schema-versioned dict of everything recorded.  Plain JSON
        types only — json.dumps(snapshot) must always succeed."""
        return {
            "schema_version": OBS_SCHEMA_VERSION,
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._hists.items())},
        }


_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry — for library code with no
    handle.  The serve loop builds a fresh registry per run instead, so
    back-to-back runs in one process never mix counters."""
    return _DEFAULT_REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _DEFAULT_REGISTRY
    prev, _DEFAULT_REGISTRY = _DEFAULT_REGISTRY, reg
    return prev


# ---------------------------------------------------------------- tracing
class Tracer:
    """Bounded-memory span/instant recorder exporting Chrome trace-event
    JSON.  Events live in a ring buffer (``capacity`` newest events;
    overflow increments ``dropped`` and evicts the oldest — recording
    never allocates past the ring).  Timestamps are microseconds on one
    monotonic clock (``time.perf_counter`` by default) relative to tracer
    construction; ``to_events`` sorts by ``ts``, so exported timestamps
    are non-decreasing even though spans are recorded at END time.

    Event kinds (Chrome trace-event ``ph``):
      "X"  complete span  (ts = start, dur = duration) — chunks, steps
      "i"  instant        — request lifecycle edges
      "M"  metadata       — process name, emitted once at export
    """

    def __init__(self, capacity: int = 65536, clock=time.perf_counter):
        assert capacity >= 1
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._buf: deque = deque(maxlen=capacity)
        self.recorded = 0
        self.pid = os.getpid()

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._buf)

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _push(self, ev: tuple) -> None:
        self._buf.append(ev)
        self.recorded += 1

    def instant(self, name: str, tid: int = 0, args: dict = None) -> None:
        self._push(("i", name, self.now_us(), int(tid), 0.0, args))

    def complete(self, name: str, t0_us: float, tid: int = 0,
                 args: dict = None) -> None:
        """Record a span that STARTED at ``t0_us`` (from :meth:`now_us`)
        and ends now."""
        self._push(("X", name, t0_us, int(tid),
                    max(0.0, self.now_us() - t0_us), args))

    @contextmanager
    def span(self, name: str, tid: int = 0, args: dict = None):
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, tid=tid, args=args)

    def to_events(self) -> list:
        """Chrome trace-event dicts, sorted by timestamp.  Every event
        carries the required ``name``/``ph``/``ts``/``pid``/``tid``."""
        events = [{"name": "process_name", "ph": "M", "ts": 0.0,
                   "pid": self.pid, "tid": 0,
                   "args": {"name": "repro-serve"}}]
        for ph, name, ts, tid, dur, args in sorted(self._buf,
                                                   key=lambda e: e[2]):
            ev = {"name": name, "ph": ph, "ts": ts, "pid": self.pid,
                  "tid": tid}
            if ph == "X":
                ev["dur"] = dur
            if ph == "i":
                ev["s"] = "t"                      # thread-scoped instant
            if args:
                ev["args"] = args
            events.append(ev)
        return events

    def export(self, path: str) -> dict:
        """Write ``{"traceEvents": [...]}`` JSON; returns summary stats."""
        events = self.to_events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"schema_version": OBS_SCHEMA_VERSION,
                             "recorded": self.recorded,
                             "dropped": self.dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return {"events": len(events), "recorded": self.recorded,
                "dropped": self.dropped, "path": path}


# ------------------------------------------------------- kernel profiling
class KernelProfiler:
    """Opt-in per-launch kernel timing (``--profile-kernels N``).

    ``attn_entry`` calls :meth:`want` once per entry invocation; every
    ``sample_every``-th launch is run to completion under
    device syncs and recorded as (entry name, spec tag, argument
    geometry) -> (launch count, total seconds).  Aggregation happens at
    record time, so memory is bounded by the number of DISTINCT
    geometries (a handful per serve run), not the launch count.

    Forcing completion per sampled launch defeats async dispatch — that
    is the point (true per-launch wall time) and why the profiler is
    opt-in rather than part of default-sampling telemetry."""

    def __init__(self, sample_every: int = 1):
        assert sample_every >= 1
        self.sample_every = sample_every
        self._tick = 0
        self.sampled = 0
        # (name, tag, geometry) -> [count, total_seconds]
        self.records: dict[tuple, list] = {}

    def want(self) -> bool:
        self._tick += 1
        return (self._tick - 1) % self.sample_every == 0

    def record(self, name: str, tag: str, geometry: tuple,
               dt_s: float) -> None:
        self.sampled += 1
        rec = self.records.setdefault((name, tag, geometry), [0, 0.0])
        rec[0] += 1
        rec[1] += dt_s


_PROFILER: KernelProfiler = None


def profiler() -> KernelProfiler:
    """The installed kernel profiler, or None (the default: attn_entry's
    hook is a single ``is None`` check per call)."""
    return _PROFILER


def set_profiler(p: KernelProfiler) -> KernelProfiler:
    global _PROFILER
    prev, _PROFILER = _PROFILER, p
    return prev
