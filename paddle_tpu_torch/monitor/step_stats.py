"""StepStats: the per-``run()`` telemetry record and its aggregator
(counterpart of ``paddle_tpu/monitor/step_stats.py``, copied).

Each executor step produces one record — step wall time, examples/sec,
fetch-sync wait, retrace/compile counters and cache hit ratio,
dispatch-queue depth, prefetcher occupancy, and device memory when the
backend reports it.  The aggregator publishes every record into the
metrics registry (histogram + counters + gauges) and keeps running
aggregates so the console reporter and bench.py can emit a one-dict
summary without replaying the JSONL log.
"""

import time

__all__ = ["StepStatsAggregator"]


class StepStatsAggregator:
    """Folds per-step records into registry metrics + running totals.

    Not itself thread-safe by design: steps are recorded from the
    training thread(s) through ``monitor.record_step``, which serializes
    under the monitor lock.
    """

    def __init__(self, registry):
        self._registry = registry
        self.reset()

    def reset(self):
        self._steps = 0
        self._examples = 0.0
        self._compiled_steps = 0
        self._step_seconds_total = 0.0
        self._fetch_sync_total = 0.0
        self._last = None
        self._t_first = None
        self._t_last = None
        # metric handles bind lazily on the first record and are cached
        # until the next reset(): the registry's get-or-create lock is
        # off the per-step path, a disabled process never materializes
        # the metrics, and reset() after a registry.reset() re-binds
        self._m_steps = None
        self._bound_gen = -1

    def _bind(self):
        r = self._registry
        self._bound_gen = r.generation
        self._m_steps = r.counter("monitor/steps_total")
        self._m_examples = r.counter("monitor/examples_total")
        self._m_step_s = r.histogram("monitor/step_seconds")
        self._m_qdepth = r.gauge("monitor/dispatch_queue_depth")
        self._m_occ = r.gauge("monitor/prefetch_occupancy")
        self._m_hit = r.gauge("monitor/compile_cache_hit_ratio")
        self._m_bytes = r.gauge("monitor/device_bytes_in_use")
        self._m_live = r.gauge("monitor/device_live_arrays")

    # ------------------------------------------------------------------
    def record(self, rec):
        """Fold one StepStats record (a plain dict) into the aggregates
        and the registry; returns the record for the exporters."""
        now = rec.get("ts", time.time())
        if self._t_first is None:
            self._t_first = now
        self._t_last = now
        self._steps += 1
        rec["step"] = self._steps
        if rec.get("warm") is False:
            self._compiled_steps += 1
        self._examples += rec.get("examples", 0) or 0
        dt = rec.get("step_seconds", 0.0) or 0.0
        self._step_seconds_total += dt
        self._fetch_sync_total += rec.get("fetch_sync_wait_s", 0.0) or 0.0
        self._last = rec

        if self._m_steps is None \
                or self._bound_gen != self._registry.generation:
            self._bind()
        self._m_steps.inc()
        if rec.get("examples"):
            self._m_examples.inc(rec["examples"])
        self._m_step_s.observe(dt)
        self._m_qdepth.set(rec.get("dispatch_queue_depth", 0) or 0)
        pf = rec.get("prefetch") or {}
        self._m_occ.set(pf.get("occupancy", 0))
        cc = rec.get("compile_cache") or {}
        if "hit_ratio" in cc:
            self._m_hit.set(cc["hit_ratio"])
        dev = rec.get("device") or {}
        if dev.get("bytes_in_use") is not None:
            self._m_bytes.set(dev["bytes_in_use"])
        if dev.get("live_arrays") is not None:
            self._m_live.set(dev["live_arrays"])
        return rec

    # ------------------------------------------------------------------
    @property
    def steps(self):
        return self._steps

    def last(self):
        """The most recent StepStats record (None before the first)."""
        return self._last

    def summary(self):
        """Aggregate view for the console reporter and bench artifacts.
        Reads fields into locals first: the console thread summarizes
        concurrently with a training-thread reset()."""
        steps, examples = self._steps, self._examples
        total, t0, t1 = self._step_seconds_total, self._t_first, self._t_last
        last = self._last
        out = {"steps": steps,
               "examples": examples,
               "steps_compiled": self._compiled_steps,
               "step_seconds_total": round(total, 6),
               "fetch_sync_wait_s_total": round(self._fetch_sync_total, 6)}
        if steps:
            out["mean_step_seconds"] = round(total / steps, 6)
        wall = (t1 - t0) if t0 is not None and t1 is not None else 0.0
        if wall > 0 and examples:
            # throughput over the whole recorded span: under async
            # dispatch per-record examples/sec measures host dispatch
            # rate; the span-wide rate is the honest steady-state number
            out["examples_per_sec"] = round(examples / wall, 2)
        if last is not None:
            for k in ("compile_cache", "dispatch_queue_depth", "prefetch",
                      "device"):
                if last.get(k) is not None:
                    out["last_" + k] = last[k]
        return out
