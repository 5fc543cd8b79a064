"""Profiler: host spans + device tracing with chrome-trace export
(counterpart of ``paddle_tpu/profiler.py``).

Host-side named spans (``RecordEvent``) are collected here and exported
as chrome-trace JSON, double-publishing into the monitor's
``span/<name>`` histograms whenever the monitor is on.  Device tracing is
``torch.profiler`` where the JAX package starts ``jax.profiler``:
``start_profiler(trace_dir=...)`` opens a ``torch.profiler.profile``
over the CPU and (where a card is present) CUDA activities, and
``stop_profiler`` writes its chrome trace into ``trace_dir``
(``device-<pid>.json``).  While that trace is on, every ``RecordEvent``
also enters ``torch.profiler.record_function(name)``, so the host spans
and the kernels they launched share one timeline.  A CUDA-graph replay
launches its kernels without their host code: the spans around it cover
the replay's launch, and the kernels show in the device trace only.
"""

import collections
import contextlib
import json
import os
import tempfile
import threading
import time

from . import monitor

__all__ = [
    "RecordEvent", "record_event", "mark_event", "profiler",
    "start_profiler", "stop_profiler", "reset_profiler", "is_profiling",
    "export_chrome_tracing", "summarize_events", "cuda_profiler",
    "npu_profiler",
]

_state = threading.local()
_events = []
_events_lock = threading.Lock()
_enabled = [False]
# a session or a device trace is on: the executor's one read of the
# profiler before it builds spans
_active = [False]
# the torch.profiler session of start_profiler(trace_dir=...) and its dir
_device_trace = [None, None]
# tid -> thread name at the time the thread last emitted an event, for
# the chrome-trace M-phase thread_name metadata (dispatch/prefetch
# worker threads are labeled in the timeline instead of raw tids)
_thread_names = {}


def _now_us():
    return time.perf_counter_ns() / 1000.0


def _append_event(name, ts, dur, args=None):
    tid = threading.get_ident()
    ev = {
        "name": name,
        "ts": ts,
        "dur": dur,
        "ph": "X",
        "pid": os.getpid(),
        "tid": tid,
    }
    if args:
        ev["args"] = args
    with _events_lock:
        _thread_names[tid] = threading.current_thread().name
        _events.append(ev)


def is_profiling():
    """True while a profiler session is active (the executors use this
    to decide whether span correlation args are worth computing)."""
    return _enabled[0]


class RecordEvent:
    """RAII span (reference profiler.h:89 RecordEvent).

    ``__enter__`` LATCHES the profiler/monitor enabled states: a span
    that straddles ``stop_profiler`` is kept (it was started under the
    session and measures real work of it), a span started while both are
    disabled skips timing entirely — ``__exit__`` never re-decides
    post-hoc.  Completed spans double-publish into the monitor's
    ``span/<name>`` histograms whenever the monitor is on, so the two
    observability layers agree with or without a profiler session.
    """

    def __init__(self, name, args=None):
        """``args`` (optional dict) lands in the chrome-trace event's
        ``args`` field — the executors tag their dispatch/compile spans
        with ``{run_id, fingerprint, step}`` so the trace, the JSONL
        log, and /metrics can be correlated per program."""
        self.name = name
        self.args = args
        self.t0 = None
        self._prof = False
        self._mon = False
        self._fn = None

    def __enter__(self):
        self._prof = _enabled[0]
        self._mon = monitor._enabled
        if self._prof or self._mon:
            self.t0 = _now_us()
        if _device_trace[0] is not None:
            import torch

            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
        if self.t0 is None:
            return False
        dur = _now_us() - self.t0
        if self._prof:
            _append_event(self.name, self.t0, dur, self.args)
        if self._mon:
            # args ride along so the goodput ledger sees the producer's
            # bucket hint (executors tag their cold/warm step spans)
            monitor.observe_span(self.name, dur, self.args)
        self.t0 = None
        return False


record_event = RecordEvent


def mark_event(name):
    """Instantaneous event (zero-duration span): cache hits/misses and
    other point occurrences, countable in the summary and visible in the
    chrome trace next to the ``RecordEvent`` spans.  Double-publishes as
    a ``mark/<name>`` monitor counter when the monitor is on."""
    if monitor._enabled:
        monitor.mark(name)
    if not _enabled[0]:
        return
    _append_event(name, _now_us(), 0.0)


def _default_profile_path():
    return os.path.join(tempfile.gettempdir(), "profile")


def start_profiler(state="All", trace_dir=None):
    """state ∈ {CPU, GPU, All} for parity; with a ``trace_dir`` and state
    GPU or All, a ``torch.profiler`` device trace runs until
    ``stop_profiler``."""
    _enabled[0] = _active[0] = True
    if trace_dir and state in ("GPU", "All") and _device_trace[0] is None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _device_trace[:] = [prof, trace_dir]


# A window of a ``torch.profiler`` trace opens with ``TRACE_PADS`` tiny
# spin kernels (``torch.cuda._sleep``), a sync and ``TRACE_SETTLE_S`` of
# pause (``open_trace_window``), and its counts leave the pads out
# (``window_device_events``).  Kernels launched as the profiler starts
# were now and then missing from its trace (a serving window lost most of
# its first dispatch's), none once it had this pause to settle; and late
# in a long process a trace still drops its first records (a captured
# inference pass's window lost its first 21-32, 0-41 a window over a long
# run, once all 128 pads with every record of the window's own work kept:
# NVIDIA H100 80GB HBM3).  The pads take that loss.
TRACE_SETTLE_S = 0.05
TRACE_PADS = 128


def open_trace_window():
    """Begin a window of the running ``torch.profiler`` trace: the pads,
    a sync and the pause."""
    import torch

    for _ in range(TRACE_PADS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(TRACE_SETTLE_S)


Interval = collections.namedtuple("Interval", "start end")
TraceEvent = collections.namedtuple("TraceEvent", "name time_range")


def trace_events(prof, device_type):
    """The events of a finished ``torch.profiler`` trace on one device
    type, as ``prof.events()`` names and times them (``name``,
    ``time_range`` in us from the trace's start), read from the trace's
    own records.  ``prof.events()`` first builds every host and device
    event into a tree, ~60 us an event in Python: seconds for the window
    of one training step."""
    import torch
    from torch.autograd.profiler_util import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names = {}
    out = []
    for e in res.events():
        if e.device_type() != device_type \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        if _filter_name(raw):
            continue
        name = names.get(raw)
        if name is None:
            # prof.events()'s name: demangled where it is mangled
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 \
                else raw
        out.append(TraceEvent(name, Interval((e.start_ns() - t0) / 1e3,
                                             (e.end_ns() - t0) / 1e3)))
    return out


def window_device_events(prof):
    """(the device events of a finished trace that a window opened by
    ``open_trace_window``, without its pads and the ``dispatch/`` span
    annotations, the number of pads the trace kept)."""
    from torch.autograd import DeviceType

    device = [e for e in trace_events(prof, DeviceType.CUDA)
              if not e.name.startswith("dispatch/")]
    events = [e for e in device if "spin_kernel" not in e.name]
    return events, len(device) - len(events)


def kernel_events(events):
    """The kernels among device events (no copies, no memsets)."""
    return [e for e in events
            if not e.name.startswith(("Memcpy", "Memset"))]


def device_trace_path():
    """Where ``stop_profiler`` writes (or wrote) the device trace of the
    current or last session, or None."""
    return _last_device_trace[0]


_last_device_trace = [None]


def stop_profiler(sorted_key=None, profile_path=None):
    """End the session: write the device trace (when one ran) into its
    ``trace_dir``, the host spans to ``profile_path`` (default
    ``<tmp>/profile``; "" skips), and print the span summary."""
    _enabled[0] = _active[0] = False
    prof, trace_dir = _device_trace
    if prof is not None:
        _device_trace[:] = [None, None]
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "device-%d.json" % os.getpid())
        prof.export_chrome_trace(path)
        _last_device_trace[0] = path
    if profile_path is None:
        profile_path = _default_profile_path()
    if profile_path:
        export_chrome_tracing(profile_path)
    _print_summary(sorted_key)


def reset_profiler():
    with _events_lock:
        _events.clear()


def export_chrome_tracing(path):
    """Write collected host spans as chrome://tracing JSON
    (tools/timeline.py parity).  M-phase metadata events label the
    process and every emitting thread (main loop, prefetch producers,
    monitor threads) so the timeline shows names instead of raw tids."""
    with _events_lock:
        events = list(_events)
        tnames = dict(_thread_names)
    pids = sorted({e["pid"] for e in events})
    # the run correlation id rides in the process metadata AND the
    # top-level metadata dict, matching the run_id each JSONL record and
    # the /metrics exposition carry — one id across all three sinks
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "paddle_tpu_torch",
                      "run_id": monitor.run_id()}} for pid in pids]
    for (pid, tid) in sorted({(e["pid"], e["tid"]) for e in events}):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid,
                     "args": {"name": tnames.get(tid, "tid-%d" % tid)}})
    trace_meta = {"run_id": monitor.run_id()}
    gp = monitor.goodput_ledger()
    if gp.steps:
        # the run's wall-clock attribution rides in the trace metadata,
        # so a shipped trace carries its own goodput summary alongside
        # the spans it was derived from
        trace_meta["goodput"] = gp.summary()
    # request lanes: buffered trace spans render one lane
    # per request under a 'serving requests' process group — same
    # perf_counter timebase as the host spans, so the exported file
    # opens in Perfetto with requests aligned against the dispatches
    # that served them
    try:
        tr_events, tr_meta = monitor.tracing.chrome_events()
    except Exception:  # noqa: BLE001 — export never fails on telemetry
        tr_events, tr_meta = [], []
    payload = {"traceEvents": meta + tr_meta + events + tr_events,
               "displayTimeUnit": "ms", "metadata": trace_meta}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def summarize_events(events, sorted_key=None, top=50):
    """Per-name total/calls/avg/max table over chrome-trace events (the
    ``X``-phase ones; ``dur`` in microseconds).  Shared by the live
    ``stop_profiler`` summary and the offline ``tools/trace_summary.py``
    CLI, so both print the identical format.  ``top`` caps the row
    count.  Tolerates foreign traces: events missing ``dur`` (counter/
    instant events re-exported as X) count as zero-duration."""
    totals = {}
    for e in events:
        if not isinstance(e, dict) or e.get("ph", "X") != "X" \
                or "name" not in e:
            continue
        dur = e.get("dur", 0.0) or 0.0
        t = totals.setdefault(e["name"], [0.0, 0, 0.0])
        t[0] += dur
        t[1] += 1
        t[2] = max(t[2], dur)
    rows = [
        (name, tot / 1000.0, cnt, tot / cnt / 1000.0, mx / 1000.0)
        for name, (tot, cnt, mx) in totals.items()
    ]
    key = {"total": 1, "calls": 2, "ave": 3, "max": 4}.get(sorted_key, 1)
    rows.sort(key=lambda r: r[key], reverse=True)
    lines = ["%-40s %12s %8s %12s %12s" % ("Event", "total(ms)", "calls",
                                           "avg(ms)", "max(ms)")]
    for name, tot, cnt, avg, mx in rows[:top]:
        lines.append("%-40s %12.3f %8d %12.3f %12.3f"
                     % (name, tot, cnt, avg, mx))
    return "\n".join(lines)


def _print_summary(sorted_key=None):
    with _events_lock:
        events = list(_events)
    if not events:
        return
    print(summarize_events(events, sorted_key))


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             trace_dir=None):
    """Context manager parity with fluid.profiler.profiler (profiler.py:221)."""
    reset_profiler()
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*args, **kwargs):
    """Reference nvprof hook (profiler.py:39): the session above (pass
    ``trace_dir`` for the ``torch.profiler`` device trace)."""
    with profiler():
        yield


npu_profiler = cuda_profiler
