"""Serving SLO observability (counterpart of
``paddle_tpu/serving/metrics.py``): request latency percentiles, queue
and batch gauges, per-request JSONL events, poison quarantine dumps and
the goodput ledger's serving view.

Every counter, gauge and histogram also lands in ``monitor.registry()``
under ``<name>/*`` while the monitor is on (Prometheus exposition and the
console reporter for free), every request terminal emits a run_id-stamped
``serving_request`` JSONL event (with its ``trace_id`` under
``FLAGS_trace``; the terminal also closes the request's root span), and
``summary()`` divides the ledger's compute seconds by completed requests.
Exact p50/p99 come from a bounded in-memory window.  A quarantined
request is persisted as the guardian's batch quarantine is
(``request_<run_id>_<id>.npz`` of its feed, positional members, and a
JSON sidecar naming them) under ``quarantine_dir``, with a
``serving_quarantine`` event.

Besides request latency it keeps the host-clock duration of each prefill
and decode dispatch (and each ``InferenceEngine`` batch), measured by the
engine up to the outputs reaching the host (which waits for the device),
and the paged cache's and speculative decoding's counters: pages in use
and free, prefix-cache hits and misses, verify rounds and draft tokens
proposed and accepted (``paged_snapshot``).  With the monitor off nothing
here calls the monitor."""

import json
import os
import threading
import time

import numpy as np

from .. import monitor

__all__ = ["ServingMetrics"]

# latency-shaped buckets in seconds for the registry histogram
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
ACCEPTANCE_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ServingMetrics:
    """One instance per engine; every entry point is cheap and never
    raises into the serving path."""

    WINDOW = 8192                  # exact-percentile window per series

    def __init__(self, name="serving", quarantine_dir=None):
        self.name = name
        self.quarantine_dir = quarantine_dir
        self._mu = threading.Lock()
        self._lat = []             # request latency seconds
        self._exemplars = []       # (latency, trace_id)
        self._first_ts = None
        self._last_ts = None
        self._dispatch = {"prefill": [], "decode": [], "batch": [],
                          "verify": []}
        self._counts = {"submitted": 0, "completed": 0, "failed": 0,
                        "expired": 0, "quarantined": 0, "batches": 0,
                        "decode_steps": 0, "generated_tokens": 0,
                        "prefix_hits": 0, "prefix_misses": 0,
                        "spec_rounds": 0, "spec_proposed": 0,
                        "spec_accepted": 0}
        self._gauges = {}
        self._handles = {}
        self._handle_gen = -1

    # -- registry handles (only while the monitor is on) -----------------
    def _reg(self):
        return monitor.registry() if monitor._enabled else None

    def _handle(self, reg, kind, metric, **kw):
        if self._handle_gen != reg.generation:
            self._handles.clear()
            self._handle_gen = reg.generation
        h = self._handles.get(metric)
        if h is None:
            h = self._handles[metric] = getattr(reg, kind)(
                "%s/%s" % (self.name, metric), **kw)
        return h

    def _count(self, key, metric, amount=1):
        with self._mu:
            self._counts[key] = self._counts.get(key, 0) + amount
        reg = self._reg()
        if reg is not None:
            self._handle(reg, "counter", metric).inc(amount)

    def _gauge(self, metric, value):
        with self._mu:
            self._gauges[metric] = value
        reg = self._reg()
        if reg is not None:
            self._handle(reg, "gauge", metric).set(value)

    def _event(self, record):
        if monitor._enabled:
            record.setdefault("ts", time.time())
            monitor.log_event(record)

    # -- request lifecycle -------------------------------------------------
    def note_submit(self, req, queue_depth):
        self._count("submitted", "requests_total")
        self._gauge("queue_depth", queue_depth)
        with self._mu:
            if self._first_ts is None:
                self._first_ts = time.time()

    def note_admit(self, plan, occupancy, queue_depth):
        self._count("batches", "batches_total")
        self._gauge("batch_occupancy", occupancy)
        self._gauge("queue_depth", queue_depth)

    def note_decode_step(self, active, occupancy):
        self._count("decode_steps", "decode_steps_total")
        self._gauge("batch_occupancy", occupancy)

    def note_kv_pages(self, in_use, free):
        self._gauge("kv_pages_in_use", int(in_use))
        self._gauge("kv_pages_free", int(free))

    def note_prefix_cache(self, hits, misses):
        """One admission's full prompt pages aliased (hits) and written
        fresh (misses)."""
        if hits:
            self._count("prefix_hits", "prefix_cache_hits", hits)
        if misses:
            self._count("prefix_misses", "prefix_cache_misses", misses)

    def note_speculation(self, accepted, proposed):
        """One verify round: ``accepted`` of ``proposed`` draft tokens
        survived the target's greedy check."""
        self._count("spec_rounds", "speculation_rounds_total")
        self._count("spec_proposed", "speculation_proposed_total",
                    int(proposed))
        self._count("spec_accepted", "speculation_accepted_total",
                    int(accepted))
        reg = self._reg()
        if reg is not None and proposed:
            self._handle(reg, "histogram", "speculation_acceptance_rate",
                         buckets=ACCEPTANCE_BUCKETS).observe(
                             accepted / float(proposed))

    def paged_snapshot(self):
        """The paged and speculation counters, with the prefix hit rate
        and the acceptance rate."""
        with self._mu:
            snap = {k: self._counts[k] for k in (
                "prefix_hits", "prefix_misses", "spec_rounds",
                "spec_proposed", "spec_accepted")}
        total = snap["prefix_hits"] + snap["prefix_misses"]
        snap["prefix_hit_rate"] = (round(snap["prefix_hits"] / total, 4)
                                   if total else None)
        snap["spec_acceptance_rate"] = (
            round(snap["spec_accepted"] / snap["spec_proposed"], 4)
            if snap["spec_proposed"] else None)
        return snap

    def note_dispatch(self, kind, seconds):
        """One prefill, decode, verify or batch dispatch took ``seconds``
        (host clock, outputs on the host)."""
        with self._mu:
            series = self._dispatch[kind]
            series.append(float(seconds))
            del series[:-self.WINDOW]

    def note_complete(self, req, generated=0, extra=None):
        lat = ((req.finished_at - req.arrival)
               if req.finished_at is not None else 0.0)
        queue_s = ((req.admitted_at - req.arrival)
                   if req.admitted_at is not None else 0.0)
        trace = getattr(req, "trace", None)
        tid = trace.trace_id if trace is not None else None
        self._count("completed", "completed_total")
        if generated:
            self._count("generated_tokens", "generated_tokens_total",
                        int(generated))
        with self._mu:
            self._lat.append(lat)
            del self._lat[:-self.WINDOW]
            self._exemplars.append((lat, tid))
            del self._exemplars[:-self.WINDOW]
            self._last_ts = time.time()
        reg = self._reg()
        if reg is not None:
            self._handle(reg, "histogram", "request_latency_seconds",
                         buckets=LATENCY_BUCKETS).observe(lat)
        rec = {"event": "serving_request", "request_id": req.id,
               "status": "ok", "latency_ms": round(lat * 1e3, 3),
               "queue_ms": round(queue_s * 1e3, 3),
               "bucket": req.bucket, "slot": req.slot,
               "length": req.length}
        if tid is not None:
            rec["trace_id"] = tid
        if extra:
            rec.update(extra)
        self._event(rec)
        # every engine path ends here: the request's root span closes
        if trace is not None:
            trace.finish("ok", latency_ms=rec["latency_ms"])

    def note_failure(self, req, error, status="failed"):
        # a quarantine is counted by quarantine() itself
        if status != "quarantined":
            key = status if status in self._counts else "failed"
            self._count(key, "timeout_total" if key == "expired"
                        else "%s_total" % key)
        trace = getattr(req, "trace", None)
        rec = {"event": "serving_request", "request_id": req.id,
               "status": status, "error": str(error)[:200],
               "bucket": req.bucket, "length": req.length}
        if trace is not None:
            rec["trace_id"] = trace.trace_id
        self._event(rec)
        if trace is not None:
            trace.finish(status, error=str(error)[:120])

    # -- poison quarantine -------------------------------------------------
    def quarantine(self, req, feed=None, reason="non-finite output"):
        """Persist the poisoned request (``feed``: name -> array) for
        repro under ``quarantine_dir`` and publish the decision; returns
        the record.  An unwritable directory records the error in the
        event instead of failing the engine's batch."""
        self._count("quarantined", "quarantined_total")
        rec = {"event": "serving_quarantine", "request_id": req.id,
               "reason": reason, "run_id": monitor.run_id(),
               "ts": time.time(), "path": None}
        if feed is not None:
            names = sorted(feed)
            rec["feed_signature"] = [
                (n, list(np.shape(feed[n])), str(np.asarray(feed[n]).dtype))
                for n in names]
            if self.quarantine_dir:
                try:
                    os.makedirs(self.quarantine_dir, exist_ok=True)
                    base = os.path.join(
                        self.quarantine_dir, "request_%s_%s"
                        % (monitor.run_id(), req.id))
                    with open(base + ".npz", "wb") as f:
                        np.savez(f, **{"arr_%d" % i: np.asarray(feed[n])
                                       for i, n in enumerate(names)})
                    rec["feed_names"] = names
                    rec["path"] = base + ".npz"
                    with open(base + ".json", "w") as f:
                        json.dump(rec, f)
                except OSError as e:
                    rec["path"] = None
                    rec["dump_error"] = str(e)[:200]
        self._event(dict(rec))
        return rec

    # -- read side ---------------------------------------------------------
    def percentiles(self, kind=None):
        """Exact p50/p90/p99/mean seconds of request latency, or of the
        ``kind`` ("prefill" / "decode" / "verify" / "batch") dispatch
        durations."""
        with self._mu:
            vals = sorted(self._lat if kind is None else self._dispatch[kind])
        return {"p50_s": _percentile(vals, 0.50),
                "p90_s": _percentile(vals, 0.90),
                "p99_s": _percentile(vals, 0.99),
                "mean_s": (sum(vals) / len(vals)) if vals else None,
                "n": len(vals)}

    def p99_exemplars(self, k=5):
        """The trace_ids of the slowest traced requests in the window,
        slowest first (``tools/request_trace.py`` assembles each)."""
        with self._mu:
            pairs = [p for p in self._exemplars if p[1] is not None]
        pairs.sort(key=lambda p: -p[0])
        return [tid for _lat, tid in pairs[:max(1, int(k))]]

    def summary(self):
        """The counters, the gauges, exact latency percentiles, observed
        throughput and the goodput ledger's serving view."""
        with self._mu:
            counts = dict(self._counts)
            gauges = dict(self._gauges)
            first, last = self._first_ts, self._last_ts
        pct = self.percentiles()
        out = {"counts": counts, "gauges": gauges}
        for k in ("p50_s", "p90_s", "p99_s", "mean_s"):
            out[k.replace("_s", "_ms")] = (round(pct[k] * 1e3, 3)
                                           if pct[k] is not None else None)
        span = (last - first) if first and last and last > first else None
        out["throughput_rps"] = (round(counts["completed"] / span, 2)
                                 if span and counts["completed"] else None)
        gp = monitor.goodput_summary() if monitor._enabled else None
        view = {"goodput_ratio": gp.get("goodput_ratio") if gp else None,
                "compute_seconds": gp["buckets"].get("compute")
                if gp and gp.get("buckets") else None}
        if counts["completed"] and view["compute_seconds"] is not None:
            view["compute_seconds_per_request"] = round(
                view["compute_seconds"] / counts["completed"], 6)
        out["goodput_view"] = view
        out["p99_exemplars"] = self.p99_exemplars()
        return out
