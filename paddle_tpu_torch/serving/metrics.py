"""Serving counters and latency percentiles (counterpart of the parts of
``paddle_tpu/serving/metrics.py`` the generation engine calls; the
monitor registry, JSONL events and quarantine dumps are not ported).

Besides request latency it keeps the host-clock duration of each prefill
and decode dispatch (and each ``InferenceEngine`` batch), measured by the
engine up to the outputs reaching the host (which waits for the
device), and the paged cache's and speculative decoding's counters:
pages in use and free, prefix-cache hits and misses, verify rounds and
draft tokens proposed and accepted (``paged_snapshot``)."""

import threading

__all__ = ["ServingMetrics"]


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ServingMetrics:
    """One instance per engine; every entry point is cheap."""

    WINDOW = 8192                  # exact-percentile window per series

    def __init__(self):
        self._mu = threading.Lock()
        self._lat = []             # request latency seconds
        self._dispatch = {"prefill": [], "decode": [], "batch": [],
                          "verify": []}
        self._counts = {"submitted": 0, "completed": 0, "failed": 0,
                        "expired": 0, "quarantined": 0, "batches": 0,
                        "decode_steps": 0, "generated_tokens": 0,
                        "prefix_hits": 0, "prefix_misses": 0,
                        "spec_rounds": 0, "spec_proposed": 0,
                        "spec_accepted": 0}
        self._gauges = {}

    def _count(self, key, amount=1):
        with self._mu:
            self._counts[key] = self._counts.get(key, 0) + amount

    def note_submit(self, req, queue_depth):
        self._count("submitted")

    def note_admit(self, plan, occupancy, queue_depth):
        self._count("batches")

    def note_decode_step(self, active, occupancy):
        self._count("decode_steps")

    def note_kv_pages(self, in_use, free):
        with self._mu:
            self._gauges["kv_pages_in_use"] = int(in_use)
            self._gauges["kv_pages_free"] = int(free)

    def note_prefix_cache(self, hits, misses):
        """One admission's full prompt pages aliased (hits) and written
        fresh (misses)."""
        self._count("prefix_hits", hits)
        self._count("prefix_misses", misses)

    def note_speculation(self, accepted, proposed):
        """One verify round: ``accepted`` of ``proposed`` draft tokens
        survived the target's greedy check."""
        with self._mu:
            self._counts["spec_rounds"] += 1
            self._counts["spec_proposed"] += int(proposed)
            self._counts["spec_accepted"] += int(accepted)

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
        """One prefill, decode or batch dispatch took ``seconds`` (host
        clock, outputs on the host)."""
        with self._mu:
            series = self._dispatch[kind]
            series.append(float(seconds))
            del series[:-self.WINDOW]

    def note_complete(self, req, generated=0):
        lat = ((req.finished_at - req.arrival)
               if req.finished_at is not None else 0.0)
        with self._mu:
            self._counts["completed"] += 1
            self._counts["generated_tokens"] += int(generated)
            self._lat.append(lat)
            del self._lat[:-self.WINDOW]

    def note_failure(self, req, error, status="failed"):
        self._count(status if status in self._counts else "failed")

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

    def summary(self):
        """The counters and the page gauges, as ``{"counts": {...},
        "gauges": {...}}``."""
        with self._mu:
            return {"counts": dict(self._counts),
                    "gauges": dict(self._gauges)}
