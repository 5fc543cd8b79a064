"""Goodput ledger: exclusive wall-clock attribution (counterpart of
``paddle_tpu/monitor/goodput.py``: the same buckets and arithmetic; the
span names are the port's).

The monitor stack can already say *what happened* — spans, per-program
flops, step stats — but not the question every capacity decision hinges
on: of every second this run spent, how much was productive compute vs.
input wait, compile, checkpoint stall, recovery replay, autotune
probing, or plain idle?  The Dapper lesson (PAPERS.md): raw spans are
useless until an aggregation layer turns them into an attributable
timeline.  CheckFreq makes the same point for checkpoint overhead as a
*budgeted fraction* of run time — this module generalizes that fraction
into a first-class, always-computed metric.

The :class:`GoodputLedger` consumes the event streams the monitor
already carries — ``RecordEvent`` span double-publish, ``record_step``
records, ``checkpoint_saved``/``guardian_rollback``/``watchdog_stall``
JSONL events — and classifies every second of run wall-clock into
**exclusive, exhaustive buckets** (:data:`BUCKETS`):

``compute``
    the step-path remainder after the badput below is carved out — the
    seconds the accelerator was (presumably) doing the model's math.
``input_wait``
    fetch-sync waits (the async window edge blocking on the device
    chain) plus the executor's own host->device feed staging.
``trace_compile``
    what the port pays where the JAX package traces and compiles: an
    entry's analysis and segment plan (``executor/analyze``), the
    CUDA-graph capture (the ``executor/capture`` step span) and the
    first eager run of an entry (``executor/warmup``), which builds
    the kernels it launches (``cuda/build``, ``ops/cuda/build.py``).
``checkpoint_stall``
    the SYNCHRONOUS leg of checkpointing only: the device->host
    snapshot, plus the write when ``async_save`` is off.  Async
    background writes are overlap, not stall (CheckFreq), and are
    tracked separately in ``overlap_seconds``.
``recovery``
    guardian rollback work (restore scan + apply) AND the replayed
    steps after it — a replayed step re-earns a result the run already
    had, so its wall clock is badput even though the device computed.
``probe``
    autotune ladder work: steps inside a ``probe_accounting`` window
    and the compile gaps leading into them.
``pipeline_bubble``
    pipeline-schedule fill/drain waste: the ParallelExecutor carves
    ``step_seconds x bubble_fraction`` out of every warm step of a
    program whose ``pipeline_region`` ops run pipelined on a ``pp``
    mesh, where the fraction is the executed schedule's exact per-tick
    stage-idle accounting (``parallel.pipeline.schedule_stats`` — the
    same tables the lowering is built from).  This is what makes the
    GPipe-vs-interleaved/1F1B delta attributed, not inferred.
``stall_idle``
    watchdog-detected stall windows falling between steps (a hung
    reader, a wedged device with nothing dispatched).
``other``
    everything else between steps — model build, host-side bookkeeping,
    artifact IO; the honest residual that keeps the sum exhaustive.

Exhaustiveness is by construction: every ``note_step`` advances an
``accounted-until`` watermark and attributes *all* wall clock between
the old and new watermark, so the bucket seconds always sum to the
ledger's observed wall clock (the acceptance test drives a monitored
run with a forced checkpoint, an injected-NaN rollback, and an autotune
probe, and checks the sum against externally measured wall clock within
1%).  Exclusivity holds because each classified span/second is consumed
exactly once: container spans (``executor/run``), and
overlapped background work (``prefetch/h2d_transfer``, async
``checkpoint/save``) are excluded from direct attribution.

Everything here is behind the monitor's enabled gate: a dark process
pays the same single module-global bool read per step it always did.
"""

import threading
import time

__all__ = [
    "BUCKETS", "SPAN_BUCKETS", "EXCLUDED_SPANS", "classify_span",
    "GoodputLedger",
]

# the exclusive, exhaustive attribution buckets, in report order
BUCKETS = ("compute", "input_wait", "trace_compile", "checkpoint_stall",
           "recovery", "probe", "pipeline_bubble", "stall_idle", "other")

# span name -> bucket, for spans that are DIRECT badput on the step
# path.  One classification table, two consumers: the live ledger here
# and tools/trace_summary.py's offline bucket section, so a shipped
# chrome trace and the run's own goodput summary agree on attribution.
SPAN_BUCKETS = {
    "executor/fetch_sync": "input_wait",
    "parallel_executor/fetch_sync": "input_wait",
    "executor/h2d_transfer": "input_wait",
    "parallel_executor/h2d_transfer": "input_wait",
    "executor/analyze": "trace_compile",
    "executor/capture": "trace_compile",
    "executor/warmup": "trace_compile",
    "cuda/build": "trace_compile",
    "checkpoint/snapshot": "checkpoint_stall",
    "guardian/rollback": "recovery",
    "pipeline/bubble": "pipeline_bubble",
}

# spans the classifier must NOT attribute directly, and why — nested
# inside a counted span, a container around the whole step, or work
# overlapped under compute on another thread.  trace_summary renders
# these as excluded so the two views stay reconciled.
EXCLUDED_SPANS = {
    "executor/run": "container (whole step)",
    "parallel_executor/run": "container (whole step)",
    "executor/dispatch": "step remainder (compute)",
    "parallel_executor/dispatch": "step remainder (compute)",
    "prefetch/h2d_transfer": "overlap (prefetch producer thread)",
    "checkpoint/save": "classified by checkpoint_saved event "
                       "(async writes are overlap, not stall)",
    "trainer/step": "container (step + bookkeeping)",
    "trainer/checkpoint": "container (snapshot span inside is counted)",
    # serving-engine containers: each wraps one executor step, whose own
    # compile/dispatch/fetch_sync spans carry the attribution — counting
    # the container too would double-book every serving second
    "serving/batch": "container (admission batch around an executor step)",
    "serving/prefill": "container (prefill batch around an executor step)",
    "serving/decode_step": "container (decode step around an executor "
                           "step)",
    "serving/speculative_step": "container (draft and verify dispatches "
                                "around executor steps)",
}


def classify_span(name, args=None):
    """Bucket for one completed span, or None when the span must not be
    attributed directly (container / nested / overlapped — see
    :data:`EXCLUDED_SPANS`).  An explicit ``bucket`` hint in the span's
    args (the executors tag their cold/warm step spans) wins over the
    name table, so new span names inherit attribution from their
    producer instead of silently landing nowhere.  ``args`` may be any
    user payload (RecordEvent doesn't validate it); only dicts are
    inspected — this must never raise into the step path."""
    if isinstance(args, dict):
        hint = args.get("bucket")
        if hint in BUCKETS:
            # step-span hints ("compute") describe the step remainder,
            # which note_step derives — only badput hints attribute
            return None if hint == "compute" else hint
    if name in EXCLUDED_SPANS:
        return None
    return SPAN_BUCKETS.get(name)


class GoodputLedger:
    """Turns the monitor's span/step/event streams into the exclusive
    wall-clock attribution above.

    Feed order does not matter within a step: spans and events arrive
    as they complete, and the following ``note_step`` (or a read-only
    ``summary``) attributes everything up to its own completion time.
    All entry points take their own lock and never raise into the step
    path."""

    # emit a cumulative ``goodput`` JSONL record every N steps so an
    # offline replay has checkpoints, not just per-step deltas
    EMIT_EVERY = 25
    # rolling per-step deltas kept for the watchdog's stall snapshot
    RECENT_STEPS = 32

    def __init__(self, registry=None):
        self._mu = threading.RLock()
        self._registry = registry
        self.reset()

    # ------------------------------------------------------------------
    def reset(self, now=None):
        """Start a fresh attribution window (monitor enable boundary,
        bench rung starts).  ``now`` defaults to the current wall
        clock; the first activity after reset re-anchors the start so a
        ledger reset long before the run does not book the dead time."""
        with self._mu:
            self._t_start = now          # None until first activity
            self._t_accounted = now
            self._totals = {b: 0.0 for b in BUCKETS}
            self._overlap = {}           # e.g. checkpoint_save (async)
            self._steps = 0
            self._probe_steps = 0
            self._recovery_steps = 0
            self._replay_debt = 0
            self._pending = []           # (bucket, seconds, t_done)
            self._stalls = []            # (t0, t1) watchdog windows
            self._recent = []            # (t_end, delta dict)
            self._emit_countdown = 1     # first step emits a record
            self._handles = None
            self._handle_gen = -1

    # -- feeds ---------------------------------------------------------
    def note_span(self, name, dur_s, args=None, now=None):
        """One completed span from ``monitor.observe_span``."""
        bucket = classify_span(name, args)
        if bucket is None:
            return
        now = time.time() if now is None else now
        with self._mu:
            self._touch(now - dur_s)
            self._pending.append((bucket, float(dur_s), now))

    def note_event(self, rec):
        """One JSONL record from ``monitor.log_event`` (tee).  Only the
        event kinds the ledger understands are inspected; everything
        else returns after one dict read."""
        ev = rec.get("event")
        if ev == "checkpoint_saved":
            secs = float(rec.get("seconds") or 0.0)
            if secs <= 0:
                return
            with self._mu:
                self._touch(rec.get("ts"))
                if rec.get("async"):
                    # background write under compute: overlap, not
                    # stall (CheckFreq) — reported, never bucketed
                    self._overlap["checkpoint_save"] = \
                        self._overlap.get("checkpoint_save", 0.0) + secs
                else:
                    self._pending.append(
                        ("checkpoint_stall", secs,
                         rec.get("ts") or time.time()))
        elif ev == "guardian_rollback":
            with self._mu:
                self._touch(rec.get("ts"))
                # the NEXT replay_steps completed steps re-earn work the
                # run already had: badput, attributed to recovery
                self._replay_debt += max(0, int(
                    rec.get("replay_steps") or 0))
        elif ev == "watchdog_stall":
            ts = rec.get("ts")
            dur = float(rec.get("stalled_for_s") or 0.0)
            if ts and dur > 0:
                with self._mu:
                    self._touch(ts - dur)
                    self._stalls.append((ts - dur, ts))
                    del self._stalls[:-16]

    def note_step(self, rec, now=None):
        """One completed executor step from ``monitor.record_step``.
        Attributes ALL wall clock since the previous watermark — the
        between-step gap, then the step itself — and returns the delta
        dict (nonzero buckets only) for the step's JSONL record."""
        now = time.time() if now is None else now
        step_s = float(rec.get("step_seconds") or 0.0)
        probe = bool(rec.get("probe"))
        with self._mu:
            self._touch(now - step_s)
            delta = {b: 0.0 for b in BUCKETS}
            t_begin = max(self._t_accounted, min(now - step_s, now))
            # --- the gap between the previous watermark and this step
            self._attribute_gap(self._t_accounted, t_begin, delta,
                                probe=probe)
            # --- the step itself: replay > probe > span carve-out
            in_step = self._drain_pending(t_begin)
            base = max(0.0, now - t_begin)
            span_s = min(base, step_s) if step_s > 0 else base
            if self._replay_debt > 0 and not probe:
                self._replay_debt -= 1
                self._recovery_steps += 1
                delta["recovery"] += span_s
            elif probe:
                self._probe_steps += 1
                delta["probe"] += span_s
            else:
                # the pipeline-bubble carve-out applies to the step's
                # COMPUTE REMAINDER, not the whole step: the emitted
                # span encodes the schedule's idle fraction as
                # seconds/step_seconds, and input-wait/compile seconds
                # were never pipelined time.  Recover the fraction and
                # apply it after the other carve-outs.
                bub = in_step.pop("pipeline_bubble", 0.0)
                known = sum(in_step.values())
                if known > span_s > 0:
                    # nesting/measurement noise: scale the carve-out
                    # down rather than let compute go negative
                    scale = span_s / known
                    in_step = {b: s * scale for b, s in in_step.items()}
                    known = span_s
                for b, s in in_step.items():
                    delta[b] += s
                rem = max(0.0, span_s - known)
                if bub > 0 and span_s > 0:
                    frac = min(1.0, bub / span_s)
                    delta["pipeline_bubble"] += frac * rem
                    rem -= frac * rem
                delta["compute"] += rem
            # any residue between span_s and the full watermark advance
            # (a step that began before the previous watermark —
            # concurrent executors) stays attributed: the gap handler
            # above covered [t_accounted, t_begin], and span_s covers
            # [t_begin, now]
            self._t_accounted = now
            self._steps += 1
            self._fold(delta)
            self._recent.append((now, delta))
            del self._recent[:-self.RECENT_STEPS]
            self._emit_countdown -= 1
            emit = self._emit_countdown <= 0
            if emit:
                self._emit_countdown = self.EMIT_EVERY
            self._publish()
        out = {b: round(s, 6) for b, s in delta.items() if s > 0}
        return out, emit

    # -- internals -----------------------------------------------------
    def _touch(self, t):
        """Anchor the window start at the FIRST observed activity."""
        if t is None:
            t = time.time()
        if self._t_start is None or t < self._t_start:
            self._t_start = t
        if self._t_accounted is None or self._t_accounted < self._t_start:
            self._t_accounted = self._t_start

    def _drain_pending(self, t_begin):
        """Split the pending classified spans at ``t_begin``: spans that
        completed inside the step window return as the in-step carve-out
        {bucket: seconds}; earlier ones stay pending for the gap
        handler.  Caller holds the lock."""
        in_step, remain = {}, []
        for bucket, secs, t_done in self._pending:
            # strictly after: a span completing exactly at the step
            # boundary belongs to the gap (the gap drain is inclusive,
            # so the pair of boundaries leaves nothing stuck pending)
            if t_done > t_begin:
                in_step[bucket] = in_step.get(bucket, 0.0) + secs
            else:
                remain.append((bucket, secs, t_done))
        self._pending = remain
        return in_step

    def _stall_overlap(self, t0, t1):
        """Seconds of watchdog stall windows overlapping [t0, t1);
        consumed windows are trimmed so no stall second counts twice."""
        total = 0.0
        keep = []
        for s0, s1 in self._stalls:
            lo, hi = max(s0, t0), min(s1, t1)
            if hi > lo:
                total += hi - lo
                if s1 > t1:       # tail extends past the gap: keep it
                    keep.append((t1, s1))
            else:
                keep.append((s0, s1))
        self._stalls = keep
        return total

    def _attribute_gap(self, t0, t1, delta, probe=False, drain=True):
        """Attribute the between-step wall clock [t0, t1): first the
        classified gap spans (sync checkpoint legs, rollback restores),
        then watchdog stall overlap, then probe lead-in compiles, then
        the honest ``other`` residual.  Caller holds the lock."""
        gap = max(0.0, (t1 or 0.0) - (t0 or 0.0))
        if gap <= 0:
            return
        known = {}
        if drain:
            remain = []
            for bucket, secs, t_done in self._pending:
                if t_done <= t1:
                    known[bucket] = known.get(bucket, 0.0) + secs
                else:
                    remain.append((bucket, secs, t_done))
            self._pending = remain
        known_total = sum(known.values())
        if known_total > gap > 0:
            scale = gap / known_total
            known = {b: s * scale for b, s in known.items()}
            known_total = gap
        for b, s in known.items():
            delta[b] += s
        rest = gap - known_total
        if rest <= 0:
            return
        stall = min(rest, self._stall_overlap(t0, t1))
        delta["stall_idle"] += stall
        rest -= stall
        if rest <= 0:
            return
        # the gap leading into a probe step is probe work too: the
        # tuner's cost_analysis compiles happen between its steps
        delta["probe" if probe else "other"] += rest

    def _fold(self, delta):
        for b, s in delta.items():
            if s:
                self._totals[b] += s

    def _publish(self):
        """Registry twin of the totals: ``badput/<bucket>_seconds``
        counters, a ``goodput/compute_seconds`` counter, and the
        ``goodput/ratio`` gauge.  Handles are cached per registry
        generation like the monitor's span histograms.  Caller holds
        the lock."""
        reg = self._registry
        if reg is None:
            return
        if self._handles is None or self._handle_gen != reg.generation:
            self._handle_gen = reg.generation
            self._handles = {"ratio": reg.gauge("goodput/ratio"),
                             "wall": reg.gauge("goodput/wall_seconds"),
                             "compute":
                             reg.counter("goodput/compute_seconds")}
            for b in BUCKETS[1:]:
                self._handles[b] = reg.counter(
                    "badput/%s_seconds" % b)
            self._published = {b: 0.0 for b in BUCKETS}
        for b in BUCKETS:
            inc = self._totals[b] - self._published[b]
            if inc > 0:
                (self._handles["compute"] if b == "compute"
                 else self._handles[b]).inc(inc)
                self._published[b] += inc
        wall = sum(self._totals.values())
        self._handles["wall"].set(wall)
        if wall > 0:
            self._handles["ratio"].set(self._totals["compute"] / wall)

    # -- read side -----------------------------------------------------
    @property
    def steps(self):
        return self._steps

    def totals(self):
        """Attributed bucket seconds so far (no tail projection)."""
        with self._mu:
            return dict(self._totals)

    def summary(self, now=None):
        """The per-run attribution summary: bucket seconds (with the
        not-yet-attributed tail folded through the same gap classifier,
        so the dict is exhaustive as of ``now``), total wall, goodput
        ratio, step/replay/probe counts, and the overlapped (non-stall)
        seconds for context.  Read-only: the watermark does not move."""
        now = time.time() if now is None else now
        with self._mu:
            buckets = dict(self._totals)
            if self._t_start is not None and self._t_accounted is not None:
                tail = {b: 0.0 for b in BUCKETS}
                # non-mutating pass: classify the pending spans/stalls
                # in the tail without consuming them
                pending, stalls = self._pending, self._stalls
                try:
                    self._pending = list(pending)
                    self._stalls = list(stalls)
                    self._attribute_gap(self._t_accounted, now, tail)
                finally:
                    self._pending, self._stalls = pending, stalls
                for b, s in tail.items():
                    buckets[b] += s
            buckets = {b: round(s, 6) for b, s in buckets.items()}
            wall = sum(buckets.values())
            out = {"buckets": buckets,
                   "wall_seconds": round(wall, 6),
                   "goodput_ratio": round(buckets["compute"] / wall, 4)
                   if wall > 0 else None,
                   "steps": self._steps,
                   "probe_steps": self._probe_steps,
                   "recovery_replayed_steps": self._recovery_steps,
                   "overlap_seconds": {k: round(v, 6) for k, v
                                       in self._overlap.items()}}
            return out

    def snapshot_for_stall(self):
        """Compact recent-window view for the watchdog's stall dump: a
        stall report that says '97% input_wait over the last window' is
        actionable; 'no step completed' is not."""
        with self._mu:
            recent = list(self._recent)
            cum = self.summary()
        window = {}
        for _, delta in recent:
            for b, s in delta.items():
                window[b] = window.get(b, 0.0) + s
        total = sum(window.values())
        out = {"cumulative_ratio": cum["goodput_ratio"],
               "recent_steps": len(recent)}
        if total > 0:
            out["recent_fractions"] = {
                b: round(s / total, 3) for b, s in sorted(
                    window.items(), key=lambda kv: -kv[1]) if s > 0}
        return out
