"""Monitor exporters: rotating JSONL event log, Prometheus-style text
exposition over a tiny stdlib HTTP endpoint, and a periodic console
reporter (counterpart of ``paddle_tpu/monitor/exporters.py``,
copied).

All three read the same registry/aggregator state; none of them sits on
the step hot path (the JSONL writer is called once per step from
``monitor.record_step``, the other two run on their own daemon threads).
"""

import json
import os
import sys
import threading
import time

__all__ = ["JsonlWriter", "ConsoleReporter", "start_http_server"]


class JsonlWriter:
    """Rotating JSONL event log: one JSON object per line (StepStats
    records, watchdog diagnostics, lifecycle events).  Rotation keeps
    ``backups`` closed generations (``monitor-<pid>.jsonl.1``...) so an
    always-on training job cannot fill the disk."""

    def __init__(self, log_dir, prefix="monitor", max_bytes=64 << 20,
                 backups=2):
        self.log_dir = log_dir
        self.max_bytes = int(max_bytes)
        self.backups = int(backups)
        os.makedirs(log_dir, exist_ok=True)
        # pid-suffixed so bench-ladder rung subprocesses sharing one
        # FLAGS_monitor_log_dir never interleave within a file
        self.path = os.path.join(log_dir, "%s-%d.jsonl"
                                 % (prefix, os.getpid()))
        self._mu = threading.Lock()
        self._f = open(self.path, "a")

    def write(self, record):
        try:
            line = json.dumps(record, default=_json_default)
        except Exception:  # noqa: BLE001 — telemetry never breaks the step
            return
        with self._mu:
            if self._f is None:
                return
            try:
                self._f.write(line + "\n")
                # flush per line: the log's job is post-mortem diagnosis
                # of hangs/crashes, exactly when buffered tails get lost
                self._f.flush()
                if self._f.tell() >= self.max_bytes:
                    self._rotate()
            except OSError as e:
                # disk full / fs error: drop the writer rather than let
                # a telemetry write kill the training step
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
                print("[monitor] event log disabled: %r" % e,
                      file=sys.stderr, flush=True)

    def _rotate(self):
        self._f.close()
        self._f = None           # stays None if the re-open below fails
        for i in range(self.backups, 0, -1):
            src = self.path + (".%d" % (i - 1) if i > 1 else "")
            dst = self.path + ".%d" % i
            if os.path.exists(src):
                os.replace(src, dst)
        self._f = open(self.path, "a")

    def close(self):
        with self._mu:
            if self._f is not None:
                self._f.close()
                self._f = None


def _json_default(o):
    try:
        return float(o)       # numpy scalars, 0-d tensors
    except (TypeError, ValueError):
        return repr(o)


class ConsoleReporter:
    """Daemon thread printing a one-line monitor summary every
    ``interval_s`` seconds (stderr, so stdout JSON artifacts like
    bench.py's stay machine-parseable)."""

    def __init__(self, aggregator, registry, interval_s=30.0,
                 stream=None):
        self._agg = aggregator
        self._registry = registry
        self.interval_s = float(interval_s)
        self._stream = stream
        self._stop = threading.Event()
        self._thread = None

    def format_line(self):
        s = self._agg.summary()
        parts = ["[monitor] steps=%d" % s.get("steps", 0)]
        if "mean_step_seconds" in s:
            parts.append("step_ms=%.3f" % (s["mean_step_seconds"] * 1e3))
        if "examples_per_sec" in s:
            parts.append("ex/s=%.1f" % s["examples_per_sec"])
        cc = s.get("last_compile_cache") or {}
        if "hit_ratio" in cc:
            parts.append("cache_hit=%.0f%%" % (100.0 * cc["hit_ratio"]))
        if "last_dispatch_queue_depth" in s:
            parts.append("queue=%d" % s["last_dispatch_queue_depth"])
        pf = s.get("last_prefetch") or {}
        if pf.get("capacity"):
            parts.append("prefetch=%d/%d" % (pf.get("occupancy", 0),
                                             pf["capacity"]))
        stalls = self._registry.get("monitor/watchdog_stalls")
        if stalls is not None and stalls.value:
            parts.append("STALLS=%d" % stalls.value)
        return " ".join(parts)

    def report_once(self):
        print(self.format_line(), file=self._stream or sys.stderr,
              flush=True)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.report_once()
            except Exception:  # noqa: BLE001 — a race with a concurrent
                pass           # aggregator reset must not kill the thread

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="monitor-console", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def start_http_server(port, expose_fn, host="127.0.0.1"):
    """Serve ``expose_fn()`` (Prometheus text) at ``/metrics`` on a
    daemon thread.  ``port=0`` binds an ephemeral port; the bound server
    is returned (``server.server_address[1]`` is the port,
    ``server.shutdown()`` stops it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = expose_fn().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # scrapes are not console news
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever,
                         name="monitor-http", daemon=True)
    t.start()
    return server
