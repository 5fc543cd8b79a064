"""Watchdog: turn a silent pipeline hang into a diagnostic (counterpart
of ``paddle_tpu/monitor/watchdog.py``, copied).

A stalled dispatch thread, a prefetch producer stuck on a dead source,
or a device-side wedge all look identical from the training loop: no
step completes.  The watchdog tracks (a) the last completed step and
(b) per-thread heartbeats from the dispatch/prefetch workers; when no
step completes within ``stall_seconds`` it fires a diagnostic — queue
states, heartbeat ages, the last completed span — through its sink
(JSONL log + stderr + a ``monitor/watchdog_stalls`` counter) instead of
letting the job hang mutely.  It never raises or kills anything: the
stall may be a genuinely slow step (giant compile), so the dump is
evidence, not a verdict.
"""

import threading
import time

__all__ = ["Watchdog"]


class Watchdog:
    """``heartbeat(name)`` from worker threads, ``step_completed()``
    from the executors, ``check()`` evaluates the stall condition
    (callable manually in tests; ``start()`` runs it on a daemon thread
    every ``stall_seconds/4``, capped at 1s)."""

    def __init__(self, stall_seconds, sink=None, probe=None):
        self.stall_seconds = float(stall_seconds)
        self._sink = sink          # callable(diagnostic_dict)
        self._probe = probe        # callable() -> extra context dict
        self._hb = {}              # name -> last monotonic heartbeat
        self._last_step = time.monotonic()
        self._steps = 0
        self._last_fired = None
        self._stop = threading.Event()
        self._thread = None

    # -- signals -------------------------------------------------------
    def heartbeat(self, name):
        # single dict-slot store: atomic under the GIL, no lock on the
        # worker hot path
        self._hb[name] = time.monotonic()

    def step_completed(self):
        self._steps += 1
        self._last_step = time.monotonic()
        self._last_fired = None    # re-arm: progress clears the alarm

    # -- evaluation ----------------------------------------------------
    def check(self, now=None):
        """Returns the diagnostic dict if the pipeline is stalled (and
        feeds it to the sink), else None.  Fires at most once per stall
        window so a long hang logs a heartbeat-rate trickle, not a
        flood."""
        now = time.monotonic() if now is None else now
        age = now - self._last_step
        if age < self.stall_seconds:
            return None
        if self._last_fired is not None \
                and now - self._last_fired < self.stall_seconds:
            return None
        self._last_fired = now
        # .copy() is atomic under the GIL; iterating self._hb directly
        # could race a worker's first-ever heartbeat insert
        hb = self._hb.copy()
        diag = {"event": "watchdog_stall",
                "ts": time.time(),
                "stalled_for_s": round(age, 3),
                "stall_seconds": self.stall_seconds,
                "steps_completed": self._steps,
                "heartbeat_age_s": {
                    n: round(now - t, 3) for n, t in sorted(hb.items())
                }}
        if self._probe is not None:
            try:
                diag.update(self._probe() or {})
            except Exception as e:  # noqa: BLE001 — diagnostics must land
                diag["probe_error"] = repr(e)
        if self._sink is not None:
            self._sink(diag)
        return diag

    # -- background thread ---------------------------------------------
    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="monitor-watchdog", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        interval = min(max(self.stall_seconds / 4.0, 0.05), 1.0)
        while not self._stop.wait(interval):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the stall detector must
                pass           # outlive any one bad check


    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
