"""Program-level cost and memory attribution (counterpart of
``paddle_tpu/monitor/program_profile.py``).

The monitor's StepStats answer "how fast is the run going"; this module
answers "which program is spending the time and the memory".  The JAX
package reads them from XLA at the one compile each (program, feed
signature) pays: ``cost_analysis()`` (flops, bytes accessed) and
``memory_analysis()``.  The port has no compiler to ask.  What it pays
for an entry is its eager warm-up run, its CUDA-graph capture and then
one replay a step, so a profile records those, measured on the card:

* ``warmup_peak_bytes``: ``torch.cuda.max_memory_allocated`` over the
  entry's first (eager) run, which builds the kernels and sizes the
  workspaces;
* ``capture_seconds`` and ``peak_capture_bytes``: the wall time of the
  capture and the allocator's peak across it;
* ``replay_device_ms``: CUDA events around the first replay;
* ``launches_per_replay`` / ``device_events_per_replay``: the kernels
  (and kernels plus copies) a ``torch.profiler`` trace of that replay
  shows (a replay runs no host code, so only a device trace sees them).

No flop or byte count is invented where XLA gave one: ``flops`` and
``bytes_accessed`` are None, and the report says "n/a".  On the CPU,
which never captures, the device fields are None too, never zero.

Per-program *step accounting* (steps, wall clock, examples) accumulates
through :func:`note_step`, fed from ``monitor.record_step``;
:func:`report_rows` joins the two into the per-program table that
``tools/program_report.py`` renders from a live registry or a JSONL log.

**Memory preflight** (``FLAGS_preflight_oom``): the JAX package predicts
the step's peak from the compiled module before its first dispatch.  The
port measures it: the eager warm-up run reports its peak, and before the
graph is made the capture compares the memory the step needs on top of
what is allocated now (warm-up peak minus the bytes in use) with the
card's free memory, or the peak itself with ``FLAGS_preflight_hbm_bytes``
when that is set.  Over it: a warning with the numbers, or
:class:`PreflightOOMError` under ``strict``, raised before the capture.
The warm-up run itself may still run out of memory: this check can only
stop the capture that would follow it.
"""

import contextlib
import os
import threading
import time
import warnings

__all__ = [
    "PreflightOOMError", "ProgramProfile", "capture_enabled",
    "program_fingerprint", "note_warmup", "preflight", "note_capture",
    "note_replay", "get", "profiles", "note_step", "accounting",
    "probe_accounting", "probe_active", "probe_totals", "summary_for",
    "report_rows", "render_table", "reset", "reset_accounting",
    "DEFAULT_PEAK_TFLOPS",
]

# a card's peak (TFLOP/s) for the MFU column, which stays empty while no
# profile has a flop count
DEFAULT_PEAK_TFLOPS = float(os.environ.get("BENCH_PEAK_TFLOPS", "989"))

_mu = threading.Lock()
# (fingerprint, feed_sig, fetch_names, kind) -> ProgramProfile
_profiles = {}
_acct = {}          # fingerprint -> {steps, wall_s, examples, kind}
_acct_probe = {}
_warned = set()     # (fingerprint, feed_sig) preflight warnings issued


class PreflightOOMError(RuntimeError):
    """The step would need more device memory than the card has free
    (``FLAGS_preflight_oom=strict``)."""


class ProgramProfile:
    """One entry's (program, feed signature, fetch set) profile."""

    __slots__ = ("fingerprint", "feed_sig", "fetch_names", "kind", "ts",
                 "flops", "bytes_accessed", "device",
                 "warmup_peak_bytes", "capture_seconds",
                 "peak_capture_bytes", "replay_device_ms",
                 "launches_per_replay", "device_events_per_replay",
                 "trace_pads_lost", "graphs")

    def __init__(self, fingerprint, feed_sig, kind, device=None,
                 fetch_names=(), flops=None, bytes_accessed=None,
                 peak_hbm_bytes=None, **_xla_breakdown):
        # ``tools/program_report.py`` rebuilds profiles from records with
        # the JAX package's keywords (argument_bytes, temp_bytes, ...):
        # accepted, and ignored, as XLA's memory breakdown has no
        # counterpart here
        self.fingerprint = fingerprint
        self.feed_sig = tuple(feed_sig)
        self.fetch_names = tuple(fetch_names)
        self.kind = kind
        self.ts = time.time()
        # no compiler's cost analysis: None unless a caller has one
        self.flops = flops or None
        self.bytes_accessed = bytes_accessed or None
        self.device = device
        self.warmup_peak_bytes = peak_hbm_bytes
        self.capture_seconds = None
        self.peak_capture_bytes = None
        self.replay_device_ms = None
        self.launches_per_replay = None
        self.device_events_per_replay = None
        self.trace_pads_lost = None
        self.graphs = None

    @property
    def peak_hbm_bytes(self):
        """The larger measured peak (warm-up or capture), or None."""
        peaks = [p for p in (self.warmup_peak_bytes,
                             self.peak_capture_bytes) if p is not None]
        return max(peaks) if peaks else None

    def breakdown(self):
        return {"warmup_peak_bytes": self.warmup_peak_bytes,
                "peak_capture_bytes": self.peak_capture_bytes,
                "peak_hbm_bytes": self.peak_hbm_bytes}

    def as_dict(self):
        d = {"fingerprint": self.fingerprint,
             "kind": self.kind,
             "feed_sig": [[n, list(s), dt] for n, s, dt in self.feed_sig],
             "fetch_names": list(self.fetch_names),
             "flops": self.flops,
             "bytes_accessed": self.bytes_accessed,
             "device": self.device,
             "capture_seconds": self.capture_seconds,
             "replay_device_ms": self.replay_device_ms,
             "launches_per_replay": self.launches_per_replay,
             "device_events_per_replay": self.device_events_per_replay,
             "trace_pads_lost": self.trace_pads_lost,
             "graphs": self.graphs}
        d.update(self.breakdown())
        return d


def program_fingerprint(program):
    """Structural fingerprint of ``program`` (``compile_cache``'s, the
    JAX package's sha1): tags step records, spans, profiles and the
    tuner's decision tables so the views of one program join."""
    from .. import compile_cache

    return compile_cache.program_fingerprint(program)


def _flag(name, default):
    from .. import flags

    try:
        return flags.flag(name)
    except KeyError:
        return default


def _preflight_mode():
    v = str(_flag("preflight_oom", "auto")).strip().lower()
    if v in ("off", "0", "false", "no", "none", ""):
        return "off"
    if v == "strict":
        return "strict"
    return "auto" if v == "auto" else "warn"


# FLAGS_preflight_oom is "warn" or "strict": profiles and the preflight
# run with the monitor off too (kept by the flag's hook, so that the
# executor reads one bool)
_FORCED = [False]


def _on_preflight_flag(val):
    _FORCED[0] = _preflight_mode() in ("warn", "strict")


def capture_enabled():
    """Whether the executor profiles its entries: the monitor is on, or
    the operator forced the preflight (``warn`` / ``strict``).  Read
    once an entry's cold run, never on a warm step."""
    from . import enabled

    return enabled() or _preflight_mode() in ("warn", "strict")


def _key(fingerprint, feed_sig, fetch_names, kind):
    return (fingerprint, tuple(feed_sig), tuple(fetch_names), kind)


def _profile(fingerprint, feed_sig, kind, fetch_names, device):
    with _mu:
        k = _key(fingerprint, feed_sig, fetch_names, kind)
        prof = _profiles.get(k)
        if prof is None:
            prof = _profiles[k] = ProgramProfile(
                fingerprint, feed_sig, kind, device=device,
                fetch_names=fetch_names)
        return prof


def _log(prof):
    """The profile's ``program_profile`` JSONL record.  A field no
    measurement gave is left out (the JAX package's record always has a
    number there, and ``tools/program_report.py`` reads a missing one as
    its default)."""
    from . import log_event

    rec = {k: v for k, v in prof.as_dict().items() if v is not None}
    log_event(dict(rec, event="program_profile", ts=time.time()))


def note_warmup(fingerprint, feed_sig, device, peak_bytes,
                kind="executor", fetch_names=()):
    """An entry's first (eager) run finished; ``peak_bytes`` is the
    allocator's peak across it (None on the CPU).  Creates the entry's
    profile."""
    prof = _profile(fingerprint, feed_sig, kind, fetch_names,
                    str(device) if device is not None else None)
    prof.warmup_peak_bytes = peak_bytes
    _log(prof)
    return prof


def _capacity(device, in_use):
    """(what the step may take, what it is compared against): the flag's
    bytes for the whole peak, else the card's free memory for the bytes
    on top of ``in_use``; None when unknown."""
    override = int(_flag("preflight_hbm_bytes", 0))
    if override > 0:
        return override, "FLAGS_preflight_hbm_bytes"
    try:
        import torch

        free = torch.cuda.mem_get_info(device)[0]
    except Exception:  # noqa: BLE001 — no card: nothing to check
        return None, None
    return free + in_use, "free device memory %s + in use %s" % (
        _fmt_mib(free), _fmt_mib(in_use))


def _fmt_mib(n):
    """Adaptive byte formatting (toy CPU-test programs are KiB-scale,
    real steps GiB-scale)."""
    if n is None:
        return "n/a"
    n = int(n)
    if n >= 1 << 30:
        return "%.2f GiB" % (n / (1 << 30))
    if n >= 1 << 20:
        return "%.1f MiB" % (n / (1 << 20))
    if n >= 1 << 10:
        return "%.1f KiB" % (n / (1 << 10))
    return "%d B" % n


def preflight(fingerprint, feed_sig, device, in_use, kind="executor",
              fetch_names=()):
    """Called before an entry's capture: compare its warm-up peak with
    the capacity (see the module docstring); warn, or raise
    :class:`PreflightOOMError` under ``strict``.  Never raises for
    missing data."""
    mode = _preflight_mode()
    if mode == "off":
        return
    if mode == "auto":
        mode = "warn"
    prof = get(fingerprint, feed_sig, kind=kind, fetch_names=fetch_names)
    if prof is None or prof.warmup_peak_bytes is None:
        return
    cap, what = _capacity(device, in_use)
    if cap is None or prof.warmup_peak_bytes <= cap:
        return
    msg = ("memory preflight: program %s (%s) measured peak %s in its "
           "eager warm-up run exceeds %s (%s): the CUDA-graph capture was "
           "not attempted" % (fingerprint[:12], kind,
                              _fmt_mib(prof.warmup_peak_bytes),
                              _fmt_mib(cap), what))
    from . import enabled, log_event, registry

    if enabled():
        registry().counter("monitor/preflight_oom").inc()
        log_event({"event": "preflight_oom", "ts": time.time(),
                   "fingerprint": fingerprint, "mode": mode,
                   "capacity_bytes": int(cap),
                   "breakdown": prof.breakdown()})
    if mode == "strict":
        raise PreflightOOMError(msg)
    key = (fingerprint, tuple(feed_sig))
    with _mu:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(msg, stacklevel=3)


def note_capture(fingerprint, feed_sig, seconds, peak_bytes, graphs,
                 kind="executor", fetch_names=()):
    """The entry's capture took ``seconds`` with the allocator peaking at
    ``peak_bytes`` and made ``graphs`` CUDA graphs."""
    prof = get(fingerprint, feed_sig, kind=kind, fetch_names=fetch_names)
    if prof is None:
        return None
    prof.capture_seconds = float(seconds)
    prof.peak_capture_bytes = peak_bytes
    prof.graphs = int(graphs)
    return prof


def note_replay(fingerprint, feed_sig, device_ms, launches, device_events,
                kind="executor", fetch_names=(), pads_lost=None):
    """The entry's first replay: its device time from CUDA events and
    the kernels (and all device events) its trace showed (None where the
    trace could not be taken); ``pads_lost``: how many of the spin
    kernels opening the trace it lost (the counts are whole while some
    pads remain)."""
    prof = get(fingerprint, feed_sig, kind=kind, fetch_names=fetch_names)
    if prof is None:
        return None
    prof.replay_device_ms = device_ms
    prof.launches_per_replay = launches
    prof.device_events_per_replay = device_events
    prof.trace_pads_lost = pads_lost
    prof.ts = time.time()
    _log(prof)
    return prof


# ---------------------------------------------------------------------------
# registry access + step accounting
# ---------------------------------------------------------------------------

def get(fingerprint, feed_sig=None, kind="executor", fetch_names=()):
    """Profile for (fingerprint, feed_sig, fetch_names, kind); with
    ``feed_sig=None`` the most recent profile of the fingerprint."""
    with _mu:
        if feed_sig is not None:
            return _profiles.get(_key(fingerprint, feed_sig, fetch_names,
                                      kind))
        best = None
        for key, p in _profiles.items():
            if key[0] == fingerprint and (best is None or p.ts >= best.ts):
                best = p
        return best


def profiles():
    with _mu:
        return list(_profiles.values())


# probe window depth: steps recorded inside one are tuner probes, kept
# out of the steady-state accounting (the tuner, autotune.py)
_probe_depth = [0]


@contextlib.contextmanager
def probe_accounting():
    """Mark the dynamic extent of a probe: every step recorded inside is
    PROBE work.  Re-entrant."""
    with _mu:
        _probe_depth[0] += 1
    try:
        yield
    finally:
        with _mu:
            _probe_depth[0] -= 1


def probe_active():
    return _probe_depth[0] > 0


def note_step(fingerprint, step_seconds, examples, kind="executor"):
    """Fold one completed step into the per-program accounting (called
    from ``monitor.record_step`` when a fingerprint is attached)."""
    with _mu:
        acct = _acct_probe if probe_active() else _acct
        a = acct.get(fingerprint)
        if a is None:
            a = acct[fingerprint] = {"steps": 0, "wall_s": 0.0,
                                     "examples": 0, "kind": kind}
        a["steps"] += 1
        a["wall_s"] += float(step_seconds or 0.0)
        a["examples"] += int(examples or 0)
        a["kind"] = kind


def accounting():
    with _mu:
        return {fp: dict(a) for fp, a in _acct.items()}


def probe_totals():
    with _mu:
        return {fp: dict(a) for fp, a in _acct_probe.items()}


def summary_for(fingerprint):
    """Compact profile + accounting summary for one program — the
    watchdog attaches this for the last program a step completed for."""
    if not fingerprint:
        return None
    prof = get(fingerprint)
    with _mu:
        a = dict(_acct.get(fingerprint) or {})
    out = {"fingerprint": fingerprint[:12]}
    if a:
        out.update({"steps": a["steps"],
                    "wall_s": round(a["wall_s"], 3)})
    if prof is not None:
        out.update({"flops": prof.flops,
                    "peak_hbm_bytes": prof.peak_hbm_bytes,
                    "capture_seconds": prof.capture_seconds,
                    "replay_device_ms": prof.replay_device_ms,
                    "launches_per_replay": prof.launches_per_replay})
    return out


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def report_rows(peak_tflops=None, profiles_by_fp=None, acct_by_fp=None,
                probe_acct_by_fp=None):
    """Join profiles + step accounting into per-program rows, sorted by
    wall clock; the ``*_by_fp`` arguments override the live registry
    (the JSONL replay of ``tools/program_report.py``)."""
    peak = (peak_tflops if peak_tflops else DEFAULT_PEAK_TFLOPS) * 1e12
    if acct_by_fp is None:
        acct_by_fp = accounting()
        if probe_acct_by_fp is None:
            probe_acct_by_fp = probe_totals()
    probe_acct_by_fp = probe_acct_by_fp or {}
    if profiles_by_fp is None:
        profiles_by_fp = {}
        for p in profiles():
            cur = profiles_by_fp.get(p.fingerprint)
            if cur is None or p.ts >= cur.ts:
                profiles_by_fp[p.fingerprint] = p
    fps = set(acct_by_fp) | set(profiles_by_fp)
    total_wall = sum((acct_by_fp.get(fp) or {}).get("wall_s", 0.0)
                     for fp in fps)

    def _row(fp, a, p, probe):
        steps = int(a.get("steps", 0))
        wall = float(a.get("wall_s", 0.0))
        row = {"fingerprint": fp, "fp12": fp[:12],
               "kind": a.get("kind") or (p.kind if p is not None else ""),
               "steps": steps, "wall_s": round(wall, 6),
               "wall_share": 0.0 if probe else round(wall / total_wall, 4)
               if total_wall > 0 else 0.0,
               "examples": int(a.get("examples", 0)),
               "flops_per_step": p.flops if p is not None else None,
               "bytes_per_step": p.bytes_accessed if p is not None
               else None,
               "peak_hbm_bytes": p.peak_hbm_bytes if p is not None
               else None,
               "capture_seconds": getattr(p, "capture_seconds", None),
               "replay_device_ms": getattr(p, "replay_device_ms", None),
               "launches_per_replay": getattr(p, "launches_per_replay",
                                              None)}
        if probe:
            row["probe"] = True
            row["mfu"] = None
        elif p is not None and wall > 0 and p.flops:
            row["mfu"] = round(p.flops * steps / wall / peak, 4)
        else:
            row["mfu"] = None
        return row

    rows = [_row(fp, acct_by_fp.get(fp) or {}, profiles_by_fp.get(fp),
                 False) for fp in fps]
    rows += [_row(fp, a, profiles_by_fp.get(fp), True)
             for fp, a in probe_acct_by_fp.items()]
    rows.sort(key=lambda r: (-r["wall_s"], r["fingerprint"]))
    return rows


def render_table(rows):
    """Fixed-width text table of :func:`report_rows` output; a number no
    measurement gave reads "n/a"."""
    hdr = "%-12s %-10s %8s %10s %7s %10s %10s %10s %8s %7s" % (
        "program", "executor", "steps", "wall(s)", "share", "GFLOP/step",
        "capture_s", "replay_ms", "launches", "MFU")
    lines = [hdr, "-" * len(hdr)]

    def num(v, fmt):
        return fmt % v if v is not None else "n/a"

    for r in rows:
        kind = ("probe:" + (r["kind"] or "?")) if r.get("probe") \
            else (r["kind"] or "?")
        flops = r.get("flops_per_step")
        lines.append("%-12s %-10s %8d %10.3f %6.1f%% %10s %10s %10s %8s %7s"
                     % (r["fp12"], kind[:10], r["steps"], r["wall_s"],
                        100.0 * r["wall_share"],
                        num(flops / 1e9 if flops else None, "%.3f"),
                        num(r.get("capture_seconds"), "%.3f"),
                        num(r.get("replay_device_ms"), "%.3f"),
                        num(r.get("launches_per_replay"), "%d"),
                        num(r.get("mfu"), "%.3f")))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def reset_accounting():
    """Drop step accounting but keep the profiles (they describe entries
    that stay captured across a monitor enable/disable flip)."""
    with _mu:
        _acct.clear()
        _acct_probe.clear()


def reset():
    """Drop everything (tests)."""
    with _mu:
        _profiles.clear()
        _acct.clear()
        _acct_probe.clear()
        _warned.clear()
