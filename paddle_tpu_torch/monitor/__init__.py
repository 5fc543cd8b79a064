"""Always-on, low-overhead training telemetry (counterpart of
``paddle_tpu/monitor/__init__.py``).

The profiler (``profiler.py``) answers "what happened inside this trace
session"; the monitor answers "is the job healthy *right now*" — in
production, with no profiler attached, at near-zero cost when disabled:

* a process-global **metrics registry** (`Counter`/`Gauge`/`Histogram`,
  ``registry()``) that every subsystem publishes into;
* **StepStats** — Executor/ParallelExecutor feed one record per
  ``run()`` (step wall time, examples/sec, fetch-sync wait,
  retrace/compile counts + cache hit ratio, dispatch-queue depth,
  prefetcher occupancy, device memory when the backend reports it);
* **exporters** — a rotating JSONL event log (``FLAGS_monitor_log_dir``),
  Prometheus-style text exposition (``expose_text()`` + an optional
  stdlib HTTP endpoint on ``FLAGS_monitor_port``), and a periodic
  console reporter (``FLAGS_monitor_console_seconds``);
* a **Watchdog** that heartbeats from the dispatch/prefetch worker
  threads and flags a hung pipeline (no step completed within
  ``FLAGS_monitor_stall_seconds``) with a diagnostic dump of queue
  states and the last completed span, instead of a silent hang.

Enablement is flag-driven: setting any of ``FLAGS_monitor``,
``FLAGS_monitor_log_dir``, or ``FLAGS_monitor_port`` turns the monitor
on (``monitor.enable()``/``disable()`` are set_flags conveniences).
Profiler spans double-publish into ``span/<name>`` histograms whenever
the monitor is on — with or without a profiler session — so the two
observability layers agree on what they both measure.

In the port the step is a CUDA graph on the card, and no host code runs
inside a replay: every span, counter and ``record_step`` sits around the
replay, and a step record's time runs to the point where its fetches
reach the host (``executor/fetch_sync``).  Where the JAX package reports
its compile cache, a record here reports the executor's graph captures
and replays and the kernel libraries ``ops/cuda/build.py`` compiled
(``capture_stats``); device memory comes from ``torch.cuda``.  The fleet
hooks (``monitor.aggregate``, ``monitor.alerts``, the stall dump's fleet
view and cluster stamp) wait for the cluster runtime (ROADMAP A7c) and
raise naming it.
"""

import os
import sys
import threading
import time
import weakref

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       DEFAULT_BUCKETS)
from .step_stats import StepStatsAggregator
from .exporters import JsonlWriter, ConsoleReporter, start_http_server
from .watchdog import Watchdog

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "StepStatsAggregator", "JsonlWriter", "ConsoleReporter",
    "start_http_server", "Watchdog",
    "enable", "disable", "enabled", "registry", "step_stats",
    "expose_text", "record_step", "observe_span", "mark", "heartbeat",
    "last_span", "queue_states", "track", "log_event", "count", "run_id",
    "sample_device_gauges", "add_stall_listener", "remove_stall_listener",
    "goodput_ledger", "goodput_summary", "goodput_stamp",
    "goodput_reset", "tracing", "health", "program_profile",
    "capture_stats", "note_graph", "reset_for_tests",
]

# fast-path gate: a module-global bool read (no lock, no flag lookup) is
# all a disabled process pays per instrumentation site
_enabled = False

# per-run correlation id: every JSONL record, step record, chrome-trace
# export, and /metrics exposition carries it, so the three views of one
# run can be joined after the fact (Dapper-style: one id, many sinks)
_RUN_ID = "%08x-%04x" % (int(time.time()) & 0xffffffff,
                         os.getpid() & 0xffff)


def run_id():
    """The process's run correlation id (stable for the process life)."""
    return _RUN_ID

_mu = threading.RLock()
_registry = MetricsRegistry()
_aggregator = StepStatsAggregator(_registry)
# goodput ledger: exclusive wall-clock attribution over the span/step/
# event streams (see goodput.py); fed only while the monitor is on
from .goodput import GoodputLedger  # noqa: E402  (needs nothing above)

_goodput = GoodputLedger(_registry)
_jsonl = None
_http = None
_console = None
_watchdog = None
_last_span = None                # (name, wall ts, duration seconds)
_span_totals = {}                # span name -> cumulative seconds
_last_fetch_sync = {}            # executor name -> fetch_sync total at
                                 # its previous record_step
# live pipeline components (AsyncDispatchQueue / DevicePrefetcher)
# self-register here; weak so the monitor never extends their lifetime
_tracked = weakref.WeakSet()
# config currently applied, so flag flips reconfigure only what changed
_applied = {}


def _flag(name, default):
    """Defensive flag read: during import-time env overrides the monitor
    flags register one at a time, so a sibling may not exist yet."""
    from .. import flags

    try:
        return flags.flag(name)
    except KeyError:
        return default


def _config():
    return {
        "on": bool(_flag("monitor", False))
        or bool(_flag("monitor_log_dir", ""))
        or int(_flag("monitor_port", 0)) > 0
        or float(_flag("monitor_console_seconds", 0.0)) > 0,
        "log_dir": _flag("monitor_log_dir", ""),
        "port": int(_flag("monitor_port", 0)),
        "stall_seconds": float(_flag("monitor_stall_seconds", 120.0)),
        "console_seconds": float(_flag("monitor_console_seconds", 0.0)),
    }


def _reconcile():
    """Bring the running components in line with the monitor flags.
    Called from every FLAGS_monitor* on_set hook."""
    global _enabled, _jsonl, _http, _console, _watchdog
    with _mu:
        cfg = _config()
        if _applied and all(_applied.get(k) == v for k, v in cfg.items()):
            return
        on = cfg["on"]
        # JSONL log
        fresh_jsonl = False
        if (cfg["log_dir"] if on else "") != _applied.get("_jsonl_dir", ""):
            if _jsonl is not None:
                _jsonl.close()
                _jsonl = None
            _applied["_jsonl_dir"] = ""
            if on and cfg["log_dir"]:
                _jsonl = JsonlWriter(cfg["log_dir"])
                fresh_jsonl = True
            _applied["_jsonl_dir"] = cfg["log_dir"] if on else ""
        # HTTP exposition endpoint
        want_port = cfg["port"] if on else 0
        if want_port != _applied.get("_http_port", 0):
            if _http is not None:
                _http.shutdown()
                _http.server_close()   # shutdown() alone leaks the fd
                _http = None
            _applied["_http_port"] = 0
            if want_port > 0:
                # an exporter that cannot start (EADDRINUSE, an
                # unwritable log dir above) raises out of enable(): a
                # monitor that goes quiet is worse than none
                _http = start_http_server(want_port, expose_text)
            _applied["_http_port"] = want_port
        # watchdog
        want_stall = cfg["stall_seconds"] if on else 0.0
        if want_stall != _applied.get("_stall", 0.0):
            if _watchdog is not None:
                _watchdog.stop()
                _watchdog = None
            if want_stall > 0:
                _watchdog = Watchdog(want_stall, sink=_stall_sink,
                                     probe=_stall_probe).start()
            _applied["_stall"] = want_stall
        # console reporter
        want_console = cfg["console_seconds"] if on else 0.0
        if want_console != _applied.get("_console", 0.0):
            if _console is not None:
                _console.stop()
                _console = None
            if want_console > 0:
                _console = ConsoleReporter(
                    _aggregator, _registry,
                    interval_s=want_console).start()
            _applied["_console"] = want_console
        _applied.update(cfg)
        newly_on = on and not _enabled
        if on != _enabled:
            # enable/disable boundaries drop the cached metric handles:
            # tests (and operators) reset the registry while disabled,
            # and a stale handle would observe into an orphaned metric
            _span_hists.clear()
            _prog_metrics.clear()
            _dev_metrics.clear()
            _aggregator.reset()
            # attribution restarts with the session: a re-enabled
            # monitor must not book the disabled stretch as idle
            _goodput.reset()
            # per-program step accounting (and the watchdog's suspect-
            # program pointer) restarts with the session; captured
            # profiles are compile artifacts and survive
            _last_fp[0] = None
            program_profile.reset_accounting()
        _enabled = on
        if newly_on or (on and fresh_jsonl):
            # set_flags applies the flag family one at a time, so the
            # writer may appear a beat after the enable flip — log the
            # lifecycle event whenever a fresh log gets its first chance
            log_event({"event": "monitor_enabled", "ts": time.time(),
                       "config": {k: v for k, v in cfg.items()
                                  if k != "on"}})


def enabled():
    return _enabled


def enable(log_dir=None, port=None, stall_seconds=None,
           console_seconds=None):
    """Turn monitoring on (optionally configuring the exporters) — a
    convenience over ``set_flags``; flags stay the source of truth."""
    from .. import flags

    updates = {"monitor": True}
    if log_dir is not None:
        updates["monitor_log_dir"] = log_dir
    if port is not None:
        updates["monitor_port"] = port
    if stall_seconds is not None:
        updates["monitor_stall_seconds"] = stall_seconds
    if console_seconds is not None:
        updates["monitor_console_seconds"] = console_seconds
    flags.set_flags(updates)


def disable():
    """Turn monitoring fully off: resets every FLAGS_monitor* flag to
    its default and stops the exporters/watchdog.  Collected metrics
    are kept (``registry().reset()`` drops them)."""
    from .. import flags

    flags.set_flags({"monitor": False, "monitor_log_dir": "",
                     "monitor_port": 0, "monitor_stall_seconds": 120.0,
                     "monitor_console_seconds": 0.0})


def registry():
    """The process-global metrics registry."""
    return _registry


def step_stats():
    """The process-global StepStats aggregator."""
    return _aggregator


def goodput_ledger():
    """The process-global goodput ledger (exclusive wall-clock
    attribution; see ``monitor/goodput.py``).  The submodule itself
    stays reachable as ``monitor.goodput`` (classifier table)."""
    return _goodput


def goodput_summary():
    """The per-run attribution summary: bucket seconds, total wall,
    goodput ratio — the live twin of ``tools/goodput_report.py``."""
    return _goodput.summary()


def goodput_stamp():
    """Log the current attribution summary as a ``goodput`` JSONL
    record (run boundaries: bench rung ends, Trainer.train exit) and
    return it."""
    summ = _goodput.summary()
    if _enabled:
        log_event(dict(summ, event="goodput", ts=time.time()))
    return summ


def goodput_reset():
    """Restart the attribution window (bench rungs call this next to
    ``step_stats().reset()`` so each rung's artifact carries its own
    attribution)."""
    _goodput.reset()


def expose_text():
    """Prometheus text exposition of every registered metric.  The
    leading comment carries the run correlation id, so a scraped
    /metrics snapshot can be joined against the JSONL log and chrome
    traces of the same run."""
    return "# run_id %s\n" % _RUN_ID + _registry.expose_text()


def track(component):
    """Register a pipeline component exposing ``monitor_state()`` (the
    dispatch queues and prefetchers self-register) for watchdog dumps
    and StepStats occupancy; weakly held."""
    _tracked.add(component)


def queue_states():
    """``monitor_state()`` of every live tracked component."""
    out = []
    try:
        # snapshot first: the watchdog thread reads while training
        # threads construct executors/prefetchers (WeakSet.add)
        comps = list(_tracked)
    except RuntimeError:       # set mutated mid-iteration; retry once
        comps = list(_tracked)
    for c in comps:
        try:
            out.append(c.monitor_state())
        except Exception as e:  # noqa: BLE001 — diagnostics must land
            out.append({"kind": type(c).__name__, "error": repr(e)})
    return out


def last_span():
    """(name, wall-clock ts, seconds) of the last completed profiler
    span double-published into the monitor, or None."""
    return _last_span


def log_event(record):
    """Write one record to the JSONL event log (no-op when unset).
    Every record is stamped with the run correlation id.  Enabled
    processes also tee the record into the goodput ledger, which is how
    checkpoint/rollback/stall events reach the attribution without the
    producers knowing about it."""
    if _enabled:
        try:
            _goodput.note_event(record)
        except Exception:  # noqa: BLE001 — telemetry never breaks a step
            pass
    j = _jsonl
    if j is not None:
        record.setdefault("run_id", _RUN_ID)
        j.write(record)


def count(name, amount=1):
    """Increment a counter iff the monitor is on — the one shared
    enabled-gated increment for decision-trail counters (guardian,
    fault harness, master reconnects), so the disabled-is-free
    contract lives in one place."""
    if _enabled:
        _registry.counter(name).inc(amount)


# ---------------------------------------------------------------------------
# instrumentation entry points (called from executor/reader/profiler)
# ---------------------------------------------------------------------------

# span histogram handles cached by name: the registry's get-or-create
# lock (and the bucket-equality check) happen once per distinct span
# name, not once per span.  _span_gen tracks the registry generation so
# a registry.reset() (tests) orphans no cached handle.
_span_hists = {}
_span_gen = [0]


def _refresh_handle_caches():
    """Drop every cached metric handle iff the registry generation moved
    (a registry.reset() orphaned them).  One shared latch for all three
    handle caches: whichever cache notices the reset first must drop
    them all, or a sibling would keep serving orphaned handles."""
    if _span_gen[0] != _registry.generation:
        _span_hists.clear()
        _prog_metrics.clear()
        _dev_metrics.clear()
        _span_gen[0] = _registry.generation


def observe_span(name, dur_us, args=None):
    """Double-publish a completed profiler span into the monitor:
    ``span/<name>`` histogram (seconds) + cumulative totals (feeds the
    StepStats fetch-sync wait and the watchdog's last-span field) + the
    goodput ledger's span classifier (``args`` may carry the producer's
    explicit ``bucket`` hint)."""
    global _last_span
    if not _enabled:
        return
    dur_s = dur_us / 1e6
    _refresh_handle_caches()
    h = _span_hists.get(name)
    if h is None:
        h = _span_hists[name] = _registry.histogram("span/" + name)
    h.observe(dur_s)
    _goodput.note_span(name, dur_s, args)
    with _mu:
        _span_totals[name] = _span_totals.get(name, 0.0) + dur_s
        _last_span = (name, time.time(), dur_s)


def mark(name):
    """Point occurrence -> counter (``profiler.mark_event`` double-
    publishes here: compile_cache hit/miss marks become counters)."""
    if not _enabled:
        return
    _registry.counter("mark/" + name).inc()


def heartbeat(name):
    """Worker-thread liveness signal (dispatch queue, prefetch
    producer); feeds the watchdog's per-thread age map."""
    if not _enabled:
        return
    w = _watchdog
    if w is not None:
        w.heartbeat(name)


# per-program metric handles (step-time histogram + steps/seconds/
# examples counters keyed by the short fingerprint), cached like the
# span histograms; _last_fp feeds the watchdog's "suspect program" line
_prog_metrics = {}
_last_fp = [None]


def _program_handles(fp12):
    _refresh_handle_caches()
    h = _prog_metrics.get(fp12)
    if h is None:
        base = "program/" + fp12
        h = _prog_metrics[fp12] = {
            "steps": _registry.counter(base + "/steps_total"),
            "seconds": _registry.counter(base + "/step_seconds_total"),
            "examples": _registry.counter(base + "/examples_total"),
            "hist": _registry.histogram(base + "/step_seconds"),
        }
    return h


def record_step(name, step_seconds, examples, dispatch_queue_depth,
                device=None, warm=None, fingerprint=None, extras=None):
    """One executor ``run()`` completed: assemble the StepStats record,
    fold it into the aggregator/registry, append it to the JSONL log,
    and pet the watchdog.  ``warm`` is the executor's own verdict on
    this step (False = it paid a trace/compile for an unseen
    program/feed signature) — the step-level compile count a healthy
    steady-state loop drives to zero.  ``fingerprint`` is the program's
    structural fingerprint: step records, the per-program metric family
    (``program/<fp12>/...``), and the program_profile step accounting
    are all tagged with it so JSONL, /metrics, and the program report
    agree on which program did what."""
    if not _enabled:
        return None
    with _mu:
        fs_total = _span_totals.get(name + "/fetch_sync", 0.0)
        fs_wait = fs_total - _last_fetch_sync.get(name, 0.0)
        _last_fetch_sync[name] = fs_total
        rec = {"event": "step_stats", "ts": time.time(), "run_id": _RUN_ID,
               "executor": name,
               "step_seconds": round(step_seconds, 6),
               "examples": int(examples) if examples else 0,
               "examples_per_sec": round(examples / step_seconds, 2)
               if examples and step_seconds > 0 else 0.0,
               "fetch_sync_wait_s": round(fs_wait, 6),
               "dispatch_queue_depth": int(dispatch_queue_depth),
               "compile_cache": capture_stats(),
               "prefetch": _prefetch_state(),
               "device": _device_state(device)}
        if extras:
            # producer-supplied step-record fields (e.g. the executors'
            # sparse_touched_rows count) — JSONL-visible per step
            rec.update(extras)
        if warm is not None:
            rec["warm"] = bool(warm)
            if not warm:
                _registry.counter("monitor/steps_compiled").inc()
        if program_profile.probe_active():
            # tuner probe steps carry the tag into the JSONL so the
            # offline program_report replay and the goodput ledger
            # exclude them from steady-state attribution
            rec["probe"] = True
        if fingerprint:
            rec["fingerprint"] = fingerprint
            _last_fp[0] = fingerprint
            h = _program_handles(fingerprint[:12])
            h["steps"].inc()
            h["seconds"].inc(step_seconds)
            h["hist"].observe(step_seconds)
            if examples:
                h["examples"].inc(examples)
            program_profile.note_step(fingerprint, step_seconds, examples,
                                      kind=name)
        # attribute this step's wall clock (and the gap before it) into
        # the goodput buckets; the per-step delta rides in the record so
        # an offline replay can rebuild the attribution exactly
        gp_delta, gp_emit = _goodput.note_step(rec, now=rec["ts"])
        if gp_delta:
            rec["goodput"] = gp_delta
        rec = _aggregator.record(rec)
        w = _watchdog
        if w is not None:
            w.step_completed()
    log_event(rec)
    if gp_emit:
        # periodic cumulative checkpoint record: replays can trust the
        # ledger's own arithmetic, not just the per-step deltas
        log_event(dict(_goodput.summary(), event="goodput",
                       ts=time.time()))
    return rec


# per-device metric handles for ParallelExecutor's mesh gauges
_dev_metrics = {}


def sample_device_gauges(devices):
    """Publish per-device memory/step gauges (``torch.device`` objects):
    a ``device/<type><index>/steps_total`` counter per step, plus
    ``bytes_in_use``/``bytes_limit`` gauges served from
    ``_device_state``'s per-device sample cache — the same cadence (and
    the same cached sample) record_step's device field uses, so a
    sampled step issues one ``memory_stats()`` per device, not two."""
    if not _enabled:
        return
    _refresh_handle_caches()
    fresh = {}
    for d in devices:
        key = "%s%s" % (getattr(d, "type", "dev"), getattr(d, "index", 0)
                        or 0)
        h = _dev_metrics.get(key)
        if h is None:
            base = "device/" + key
            h = _dev_metrics[key] = {
                "steps": _registry.counter(base + "/steps_total"),
                "in_use": _registry.gauge(base + "/bytes_in_use"),
                "limit": _registry.gauge(base + "/bytes_limit"),
                "peak": _registry.gauge(base + "/bytes_in_use_peak"),
                "_peak": 0,
                "_calls": 0,
            }
        h["steps"].inc()
        h["_calls"] += 1
        ms = _device_state(d)
        if ms.get("bytes_in_use") is not None:
            h["in_use"].set(ms["bytes_in_use"])
            # running per-device peak: tools/program_report.py's
            # min/max-across-mesh column reads these (live or replayed)
            if ms["bytes_in_use"] > h["_peak"]:
                h["_peak"] = ms["bytes_in_use"]
                h["peak"].set(h["_peak"])
            if h["_calls"] % _DEVICE_SAMPLE_EVERY == 1:
                fresh[key] = {"bytes_in_use": ms["bytes_in_use"],
                              "bytes_limit": ms.get("bytes_limit"),
                              "bytes_in_use_peak": h["_peak"]}
        if ms.get("bytes_limit") is not None:
            h["limit"].set(ms["bytes_limit"])
    # JSONL twin of the gauges, on the same decimated cadence (the
    # _device_state sample cache refreshes every Nth step): offline
    # program_report replays these into the per-device HBM columns
    if fresh:
        log_event({"event": "device_stats", "ts": time.time(),
                   "run_id": _RUN_ID, "devices": fresh})


def _prefetch_state():
    """Aggregate occupancy over every live DevicePrefetcher."""
    occ = cap = n = 0
    for s in queue_states():
        if s.get("kind") == "prefetcher" and not s.get("stopped"):
            occ += s.get("occupancy", 0)
            cap += s.get("capacity", 0)
            n += 1
    return {"live": n, "occupancy": occ, "capacity": cap}


# device-memory sampling cadence: StepStats re-samples every Nth step
# and carries the last sample forward — memory leaks are minutes-scale
# signals, steps can be sub-millisecond.  Keyed per device: a card's
# training loop interleaved with CPU eval steps must not serve the CPU
# sample (empty) as the card's.
_DEVICE_SAMPLE_EVERY = 10
_device_cache = {}            # device key -> [steps since sample, sample]


def _device_state(device):
    """Device memory of a CUDA ``device`` (``torch.cuda.memory_stats``:
    bytes the caching allocator has handed out and its peak;
    ``torch.cuda.mem_get_info``: the card's total as ``bytes_limit``),
    sampled every ``_DEVICE_SAMPLE_EVERY`` steps per device; ``{}`` for
    the CPU."""
    if device is None or getattr(device, "type", None) != "cuda":
        return {}
    key = (device.type, device.index)
    cache = _device_cache.setdefault(key, [0, None])
    if cache[1] is not None and cache[0] % _DEVICE_SAMPLE_EVERY:
        cache[0] += 1
        return cache[1]
    cache[0] = 1
    out = {}
    try:
        import torch

        ms = torch.cuda.memory_stats(device)
        out["bytes_in_use"] = int(ms.get("allocated_bytes.all.current", 0))
        out["bytes_in_use_peak"] = int(ms.get("allocated_bytes.all.peak", 0))
        out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    except Exception:  # noqa: BLE001 — telemetry never breaks the step
        pass
    cache[1] = out
    return out


# ---------------------------------------------------------------------------
# watchdog sink/probe
# ---------------------------------------------------------------------------

def _stall_probe():
    qs = queue_states()
    return {"queues": qs,
            # the in-flight serving requests (trace_id, age, state) next
            # to the suspect program: a serving stall postmortem starts
            # from the stuck REQUEST, not just the stuck program
            "serving_requests": [r for s in qs
                                 if s.get("kind") == "serving_engine"
                                 for r in s.get("requests", [])],
            "last_span": _last_span,
            "last_step": _aggregator.last(),
            "compile_cache": capture_stats(),
            # where the wall clock has been going: a stall report that
            # says "97% input_wait over the last window" is actionable;
            # "no step completed" is not
            "goodput": _goodput.snapshot_for_stall(),
            # the last per-layer model-health snapshot (FLAGS_health):
            # a stall that follows a gradient explosion should say so
            "health": health.last_snapshot(),
            # the suspect: fingerprint + cost/memory profile of the last
            # program a step completed for — a stall report should name
            # which compiled program the device is (probably) stuck in
            "last_program": program_profile.summary_for(_last_fp[0])}


# graph captures and replays (counted by the executor: captures always,
# replays while the monitor is on)
_graph_counts = {"captures": 0, "replays": 0}


def note_graph(kind, n=1):
    """The executor captured (``"captures"``) or replayed
    (``"replays"``) ``n`` CUDA graphs."""
    _graph_counts[kind] += n


def capture_stats():
    """What the port pays where the JAX package reports its compile
    cache: graphs captured and replayed, the replays' share of the two
    (``hit_ratio``, the console's ``cache_hit``), and the kernel
    libraries ``ops/cuda/build.py`` compiled in this process."""
    from ..ops.cuda import build

    cap, rep = _graph_counts["captures"], _graph_counts["replays"]
    out = {"captures": cap, "replays": rep, "builds": build.build_count[0]}
    if cap + rep:
        out["hit_ratio"] = round(rep / float(cap + rep), 4)
    return out


# stall-escalation subscribers (the guardian registers here): each
# watchdog firing is fanned out so a policy layer can COUNT stalls and
# escalate, without the watchdog itself ever deciding anything
_stall_listeners = []


def add_stall_listener(fn):
    """Subscribe ``fn(diagnostic_dict)`` to watchdog stall firings
    (called from the watchdog thread; must not raise for long-term
    health — exceptions are swallowed like any diagnostics failure)."""
    if fn not in _stall_listeners:
        _stall_listeners.append(fn)


def remove_stall_listener(fn):
    if fn in _stall_listeners:
        _stall_listeners.remove(fn)


def _stall_sink(diag):
    _registry.counter("monitor/watchdog_stalls").inc()
    log_event(diag)
    print("[monitor] WATCHDOG: no step completed in %.1fs — pipeline "
          "stalled?\n%s" % (diag["stalled_for_s"], _format_diag(diag)),
          file=sys.stderr, flush=True)
    for fn in list(_stall_listeners):
        try:
            fn(diag)
        except Exception as e:  # noqa: BLE001 — escalation must not
            print("[monitor] stall listener failed: %r" % e,  # kill the
                  file=sys.stderr, flush=True)                # watchdog


def _format_diag(diag):
    lines = []
    for q in diag.get("queues", []):
        if q.get("kind") == "serving_engine":
            continue            # rendered per-request below
        lines.append("  queue %s" % q)
    for r in diag.get("serving_requests", []):
        lines.append("  request %-12s %-8s age %8.1fs trace %s" % (
            r.get("id"), r.get("state"), r.get("age_s") or 0.0,
            r.get("trace_id") or "-"))
    for n, age in diag.get("heartbeat_age_s", {}).items():
        lines.append("  heartbeat %-30s %8.1fs ago" % (n, age))
    if diag.get("last_span"):
        name, ts, dur = diag["last_span"]
        lines.append("  last span %s (%.3fs) at %s" % (name, dur, ts))
    gp = diag.get("goodput") or {}
    if gp.get("recent_fractions"):
        lines.append("  goodput last %d steps: %s" % (
            gp.get("recent_steps", 0),
            ", ".join("%s %d%%" % (b, round(f * 100)) for b, f
                      in gp["recent_fractions"].items())))
    if diag.get("last_program"):
        lines.append("  last program %s" % diag["last_program"])
    if diag.get("health"):
        lines.append("  health %s" % health.format_snapshot(diag["health"]))
    return "\n".join(lines) if lines else "  (no pipeline state tracked)"


def reset_for_tests():
    """Turn the monitor, tracing and health off and drop every piece of
    process-global state they keep (registry, ledger, step stats, span
    totals, graph counts, profiles, the trace buffer, health snapshots),
    stopping and joining the exporter threads: one call for each test's
    fixture."""
    from .. import flags

    flags.set_flags({"trace": False, "health": False, "health_every": 10,
                     "check_nan_inf": False, "benchmark": False,
                     "preflight_oom": "auto", "preflight_hbm_bytes": 0})
    disable()
    with _mu:
        _registry.reset()
        _aggregator.reset()
        _goodput.reset()
        _span_totals.clear()
        _last_fetch_sync.clear()
        _device_cache.clear()
        _span_hists.clear()
        _prog_metrics.clear()
        _dev_metrics.clear()
        _last_fp[0] = None
        _graph_counts.update(captures=0, replays=0)
        _stall_listeners[:] = []
    program_profile.reset()
    tracing.reset()
    health._clear_for_tests()


def __getattr__(name):
    if name in ("aggregate", "alerts"):
        raise NotImplementedError(
            "monitor.%s (fleet telemetry: digests, straggler verdicts and "
            "alert rules over a cluster) is not ported to paddle_tpu_torch "
            "yet (ROADMAP Queue A7c)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


# imported last: program_profile's lazy `from . import ...` calls need
# nothing at its import time, and _reconcile/_stall_probe reference the
# module as an attribute at call time
from . import program_profile  # noqa: E402
# request tracing: reachable as monitor.tracing; its _emit imports
# run_id/log_event lazily, so order here is unconstrained
from . import tracing  # noqa: E402
# model-health probe + NaN provenance: reachable as monitor.health; the
# executor gates every call on the entry's probe, so import order is
# unconstrained here too
from . import health  # noqa: E402
