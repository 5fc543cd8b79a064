"""Process-global metrics registry: Counter / Gauge / Histogram
(counterpart of ``paddle_tpu/monitor/registry.py``, copied: stdlib only).

The always-on half of the observability story: the profiler
(``profiler.py``) collects *spans* you opt into per session; the
registry holds *metrics* that accumulate for the life of the process and
can be exported at any moment (Prometheus text exposition, JSONL, the
console reporter).  Metrics are thread-safe — the dispatch queue, the
prefetch producer thread, and the watchdog all write concurrently — and
cheap enough to update on the step hot path (one lock + a few adds; the
executors additionally gate every update on ``monitor.enabled()`` so an
unmonitored process pays a single attribute read per step).
"""

import bisect
import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]

# latency-shaped buckets in SECONDS (steps span ~100us toy programs to
# multi-second giant-batch steps); fixed — a fixed layout
# keeps histogram merges/exports trivial and the observe() cost constant
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def sanitize(name):
    """Map a span-style metric name (``executor/fetch_sync``) to a
    Prometheus-legal one (``executor_fetch_sync``)."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class Counter:
    """Monotonically increasing count (steps, cache hits, stalls)."""

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._mu:
            self._value += amount

    @property
    def value(self):
        with self._mu:
            return self._value

    def snapshot(self):
        return {"type": "counter", "name": self.name, "value": self.value}

    def expose(self):
        n = sanitize(self.name)
        return ["# TYPE %s counter" % n, "%s %s" % (n, _fmt(self.value))]


class Gauge:
    """Point-in-time value (queue depth, occupancy, bytes in use)."""

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()
        self._value = 0.0

    def set(self, value):
        with self._mu:
            self._value = float(value)

    def inc(self, amount=1):
        with self._mu:
            self._value += amount

    def dec(self, amount=1):
        with self._mu:
            self._value -= amount

    @property
    def value(self):
        with self._mu:
            return self._value

    def snapshot(self):
        return {"type": "gauge", "name": self.name, "value": self.value}

    def expose(self):
        n = sanitize(self.name)
        return ["# TYPE %s gauge" % n, "%s %s" % (n, _fmt(self.value))]


class Histogram:
    """Fixed-bucket histogram (cumulative, Prometheus semantics):
    ``observe(v)`` increments every bucket whose upper bound >= v at
    export time — internally we store per-bucket counts and cumulate on
    export, so observe() is one bisect + one add under the lock."""

    def __init__(self, name, buckets=DEFAULT_BUCKETS, help=""):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._mu = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        i = bisect.bisect_left(self.buckets, value)
        with self._mu:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        with self._mu:
            return self._count

    @property
    def sum(self):
        with self._mu:
            return self._sum

    def snapshot(self):
        with self._mu:
            counts = list(self._counts)
            s, c = self._sum, self._count
        return {"type": "histogram", "name": self.name,
                "buckets": list(self.buckets), "counts": counts,
                "sum": s, "count": c}

    def expose(self):
        snap = self.snapshot()
        n = sanitize(self.name)
        lines = ["# TYPE %s histogram" % n]
        cum = 0
        for bound, cnt in zip(snap["buckets"], snap["counts"]):
            cum += cnt
            lines.append('%s_bucket{le="%s"} %d' % (n, _fmt(bound), cum))
        cum += snap["counts"][-1]
        lines.append('%s_bucket{le="+Inf"} %d' % (n, cum))
        lines.append("%s_sum %s" % (n, _fmt(snap["sum"])))
        lines.append("%s_count %d" % (n, snap["count"]))
        return lines


def _fmt(v):
    """Prometheus number formatting: integral floats print bare."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Get-or-create metric store.  One process-global instance lives in
    ``monitor`` (``monitor.registry()``); tests may build private ones."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics = {}
        # bumped by reset(): holders of cached metric handles (monitor's
        # span-histogram cache, the StepStats aggregator) compare this to
        # drop handles orphaned by a reset
        self.generation = 0

    def _get_or_create(self, name, cls, **kwargs):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, not %s"
                    % (name, type(m).__name__, cls.__name__))
            return m

    def counter(self, name, help=""):
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name, help=""):
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name, buckets=DEFAULT_BUCKETS, help=""):
        m = self._get_or_create(name, Histogram, buckets=buckets, help=help)
        if tuple(sorted(buckets)) != m.buckets:
            raise ValueError(
                "histogram %r already registered with buckets %s"
                % (name, m.buckets))
        return m

    def get(self, name):
        with self._mu:
            return self._metrics.get(name)

    def names(self):
        with self._mu:
            return sorted(self._metrics)

    def metrics(self):
        """The live metric objects (one lock, no copies) — the digest
        builder's cheap iteration path: reading each metric's value is
        a per-metric lock, not a full snapshot() dict build."""
        with self._mu:
            return list(self._metrics.values())

    def snapshot(self):
        """{name: metric snapshot dict} for the JSONL/console exporters."""
        with self._mu:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def expose_text(self):
        """Prometheus text exposition (format version 0.0.4)."""
        with self._mu:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Drop every metric (tests)."""
        with self._mu:
            self._metrics.clear()
            self.generation += 1
