"""Per-request distributed tracing (counterpart of
``paddle_tpu/monitor/tracing.py``, copied: stdlib only; the port has no
cluster control plane yet, so the ``rpc/*``, ``cluster*`` and ``fleet*``
spans below are the reference's taxonomy, kept so records interleave).

The monitor stack answers "where did this *process's* wall clock go"
(goodput ledger, program profiles); this module answers "where did
*this request's* 24ms go".  Dapper-shaped: every serving request gets a
``trace_id``, every lifecycle stage (queue wait, page wait, prefill,
each decode tick it rode, terminal) emits one ``trace_span`` JSONL
record carrying ``trace_id``/``span_id``/``parent_id``, and the context
crosses process boundaries by riding the control-plane RPC envelope
(``cloud.MasterClient`` stamps it, ``cloud/server.py`` extracts it), so
spans written by different hosts' JSONL logs assemble into one tree
after the fact.

Discipline (CheckFreq's lesson, the monitor's existing contract):

* **disabled cost is one module-global bool read** — every producer
  gates on ``tracing.enabled()`` (or a ``req.trace is None`` check that
  the gate decided) before touching any tracing call; the serving step
  path performs ZERO tracing calls while disabled (test-enforced with a
  raising monkeypatch, like the goodput ledger's);
* **enablement rides the flag pattern**: ``FLAGS_trace`` flips the
  module bool through the same on_set-reconcile scheme as the
  ``FLAGS_monitor*`` family (``tracing.enable()``/``disable()`` are
  set_flags conveniences);
* **no new sinks**: spans emit through ``monitor.log_event`` (the
  rotating JSONL writer, run_id-stamped) plus a bounded in-process ring
  buffer so bench/tests can assemble trees without a log dir.

Span taxonomy (names are the breakdown table's contract):

* ``request`` — the root, one per serving request, emitted at the
  terminal (status ok/failed/expired/quarantined); duration is
  submit-to-terminal on the host monotonic clock.
* ``queue_wait`` — submit to admission (attrs: bucket, queue_depth,
  fill_around).
* ``page_wait`` — first paged-KV admission refusal to the grant
  (back-pressure wait; only present when the gate refused at least
  once).
* ``page_alloc`` — zero-duration grant marker (attrs: pages, shared,
  pool in_use/free).
* ``prefill`` / ``batch`` — the compiled dispatch the request rode
  (attrs: slot, batch, bucket, padding tokens).
* ``decode`` — one per decode tick the request rode (attrs: slot,
  tick, active, spec_accepted/spec_proposed under speculation).
* ``rpc/<method>`` / ``rpc_server/<method>`` / ``rpc_retry`` — the
  cluster control-plane legs (client, server, reconnect attempt).
* ``cluster_session`` / ``cluster/heartbeat`` / ``cluster/barrier`` —
  membership-session spans; RPC spans nest under them via the
  thread-local current-span context.
* ``fleet_request`` / ``route`` — the pod-scale serving legs
  (``serving.fleet``): the client-side root over route + dispatch
  (+ any re-routes), and the fleet master's routing decision.  The
  ``route`` span's context rides back on the route RESPONSE, so the
  replica-side ``request`` tree parents under the master's decision —
  one request assembles into one tree across three processes
  (client, master, replica).
"""

import collections
import contextlib
import itertools
import os
import threading
import time
import uuid

__all__ = [
    "enabled", "enable", "disable", "reset", "spans",
    "Span", "RequestTrace", "current", "use_span", "span",
    "inject", "extract", "server_span", "client_span", "now_us",
    "assemble", "breakdown", "breakdown_summary", "render_table",
    "chrome_events",
]

# fast-path gate, same shape as monitor._enabled: one module-global
# bool read is all a disabled process pays per instrumentation site
_enabled = False

# bounded in-process span buffer: bench rungs and tests assemble trees
# from here without configuring a JSONL dir; CI/cluster runs read the
# JSONL twin written through monitor.log_event
_BUFFER_SPANS = 65536
_spans = collections.deque(maxlen=_BUFFER_SPANS)

# span ids only need uniqueness within a trace; trace ids must be
# globally unique across hosts (they join cross-process logs)
_span_seq = itertools.count(1)
_PID_TAG = "%04x" % (os.getpid() & 0xffff)

_tls = threading.local()


def now_us():
    """Monotonic microseconds, same base as the profiler's chrome-trace
    timestamps (``perf_counter_ns``) so request lanes align with host
    spans in one exported timeline."""
    return time.perf_counter_ns() / 1000.0


def _new_trace_id():
    return uuid.uuid4().hex[:16]


def _new_span_id():
    return "%s-%06x" % (_PID_TAG, next(_span_seq))


def enabled():
    return _enabled


def _reconcile():
    """Bring the module bool in line with ``FLAGS_trace`` (called from
    the flag's on_set hook, monitor-family style)."""
    global _enabled
    from .. import flags

    try:
        _enabled = bool(flags.flag("trace"))
    except KeyError:       # import-time registration order
        _enabled = False


def enable():
    """Turn request tracing on — a set_flags convenience; the flag
    stays the source of truth."""
    from .. import flags

    flags.set_flags({"trace": True})


def disable():
    from .. import flags

    flags.set_flags({"trace": False})


def reset():
    """Drop the in-process span buffer (bench rungs call this at rung
    boundaries so each artifact's trees are its own)."""
    _spans.clear()


def spans():
    """Snapshot of the buffered ``trace_span`` records (dicts)."""
    return list(_spans)


def _emit(name, trace_id, span_id, parent_id, t0_us, dur_us,
          status="ok", attrs=None, ts=None):
    """Append one finished-span record to the buffer and the JSONL log.
    ``t0_us`` is the monotonic start (chrome alignment), ``ts`` the
    wall-clock start (cross-process ordering); run_id-stamped here so
    buffered records carry it even without a JSONL writer."""
    from . import run_id, log_event

    rec = {"event": "trace_span", "trace_id": trace_id,
           "span_id": span_id, "parent_id": parent_id, "name": name,
           "ts": time.time() - (now_us() - t0_us) / 1e6
           if ts is None else ts,
           "mono_us": round(t0_us, 1),
           "dur_ms": round(dur_us / 1e3, 4),
           "status": status, "run_id": run_id()}
    if attrs:
        rec["attrs"] = attrs
    _spans.append(rec)
    try:
        log_event(dict(rec))
    except Exception:  # noqa: BLE001 — telemetry never breaks the path
        pass
    return rec


class Span:
    """One explicit span: created open, emitted on ``finish`` (emission
    is idempotent — the second finish is a no-op).  ``parent`` may be a
    Span or an extracted RPC context."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "_ts", "_done")

    def __init__(self, name, parent=None, trace_id=None, attrs=None):
        self.name = name
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = trace_id or _new_trace_id()
            self.parent_id = None
        self.span_id = _new_span_id()
        self.attrs = dict(attrs) if attrs else {}
        self._t0 = now_us()
        self._ts = time.time()
        self._done = False

    def child(self, name, attrs=None):
        return Span(name, parent=self, attrs=attrs)

    def context(self):
        """The propagated wire context (the Dapper tuple): what an RPC
        envelope carries across the process boundary."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def event(self, name, attrs=None, status="ok"):
        """Zero-duration child marker (reconnect attempts, grants)."""
        _emit(name, self.trace_id, _new_span_id(), self.span_id,
              now_us(), 0.0, status=status, attrs=attrs)

    def emit_open(self):
        """Emit the span NOW with status ``open`` (long-lived session
        roots: the anchor must exist in the log even if the process
        dies before ``finish``).  ``finish`` re-emits the same span_id
        with the terminal status; assembly prefers the terminal one."""
        _emit(self.name, self.trace_id, self.span_id, self.parent_id,
              self._t0, 0.0, status="open", attrs=self.attrs or None,
              ts=self._ts)

    def finish(self, status="ok", **attrs):
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        _emit(self.name, self.trace_id, self.span_id, self.parent_id,
              self._t0, now_us() - self._t0, status=status,
              attrs=self.attrs or None, ts=self._ts)


class _Ctx:
    """An extracted wire context acting as a Span-shaped parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id


def current():
    """The calling thread's current span (set by ``use_span``/``span``),
    or None — what ``MasterClient.call`` parents its rpc spans to."""
    return getattr(_tls, "span", None)


@contextlib.contextmanager
def use_span(s):
    """Install ``s`` as the thread's current span for the block
    (None = no-op), so nested RPC calls parent to it."""
    if s is None:
        yield None
        return
    prev = getattr(_tls, "span", None)
    _tls.span = s
    try:
        yield s
    finally:
        _tls.span = prev


@contextlib.contextmanager
def span(name, parent=None, attrs=None):
    """Create-install-finish in one block: finishes ``ok`` on normal
    exit, ``error`` when the block raises.  Yields None when tracing is
    disabled (the block runs untraced)."""
    if not _enabled:
        yield None
        return
    s = Span(name, parent=parent if parent is not None else current(),
             attrs=attrs)
    prev = getattr(_tls, "span", None)
    _tls.span = s
    try:
        yield s
    except BaseException:
        s.finish("error")
        raise
    finally:
        _tls.span = prev
        s.finish("ok")


# -- RPC propagation ---------------------------------------------------------

def client_span(method, endpoint):
    """The client leg of one RPC: a child of the thread's current span
    (or a fresh root outside any session context)."""
    return Span("rpc/%s" % method, parent=current(),
                attrs={"method": method, "endpoint": endpoint})


def inject(envelope, s=None):
    """Stamp the wire context into an RPC envelope dict (no-op when
    tracing is off or no span is given/current)."""
    s = s if s is not None else current()
    if _enabled and s is not None:
        envelope["trace"] = s.context()
    return envelope


def extract(ctx):
    """Wire context -> a parent for server-side spans (None-safe)."""
    if not ctx or "trace_id" not in ctx:
        return None
    return _Ctx(ctx["trace_id"], ctx.get("span_id"))


def server_span(method, ctx):
    """The server leg: a child of the extracted client context (or a
    fresh root for untraced callers)."""
    return Span("rpc_server/%s" % method, parent=extract(ctx),
                attrs={"method": method})


# -- per-request lifecycle helper -------------------------------------------

class RequestTrace:
    """One serving request's span bookkeeping, hung on
    ``ServingRequest.trace`` by the engine's submit when tracing is on
    (None otherwise — every later site gates on that None, so the
    disabled path never calls in here).

    Keyed by REQUEST, never by slot: a freed slot re-prefilled between
    decode ticks carries the new request's RequestTrace (the PR-16
    OOB-sentinel discipline, regression-tested).

    ``parent`` (a Span or extracted RPC context) adopts the caller's
    trace: a fleet replica serving an RPC-dispatched request joins the
    remote caller's tree instead of rooting its own."""

    __slots__ = ("trace_id", "root_id", "root_parent_id", "request_id",
                 "_t0", "_ts", "_attrs", "_queue_t0", "_queue_open",
                 "_page_t0", "ticks", "_done")

    def __init__(self, request_id, kind, length, parent=None, **attrs):
        if parent is not None:
            self.trace_id = parent.trace_id
            self.root_parent_id = parent.span_id
        else:
            self.trace_id = _new_trace_id()
            self.root_parent_id = None
        self.root_id = _new_span_id()
        self.request_id = request_id
        self._t0 = now_us()
        self._ts = time.time()
        self._attrs = {"request_id": request_id, "kind": kind,
                       "length": int(length)}
        self._attrs.update(attrs)
        self._queue_t0 = self._t0
        self._queue_open = True
        self._page_t0 = None
        self.ticks = 0
        self._done = False
        if self.root_parent_id is not None:
            # cross-process request: anchor the root NOW, open-status.
            # A replica SIGKILLed mid-request must leave a ROOTED open
            # subtree behind — orphan children with an unemitted parent
            # would break the remote caller's tree assembly (the fleet
            # failover drill's --assert-complete depends on this).
            _emit("request", self.trace_id, self.root_id,
                  self.root_parent_id, self._t0, 0.0, status="open",
                  attrs=dict(self._attrs), ts=self._ts)

    def _child(self, name, t0_us, dur_us, attrs=None, status="ok"):
        _emit(name, self.trace_id, _new_span_id(), self.root_id,
              t0_us, dur_us, status=status, attrs=attrs)

    # -- lifecycle hooks (engine side) ---------------------------------
    def admitted(self, bucket, queue_depth, fill_around):
        """Scheduler admission: closes the queue_wait span."""
        if not self._queue_open:
            return
        self._queue_open = False
        now = now_us()
        self._child("queue_wait", self._queue_t0, now - self._queue_t0,
                    attrs={"bucket": bucket, "queue_depth": queue_depth,
                           "fill_around": bool(fill_around)})

    def page_refused(self):
        """Paged-KV admission gate refusal: the back-pressure wait
        starts at the FIRST refusal (later refusals extend it)."""
        if self._page_t0 is None:
            self._page_t0 = now_us()

    def pages_granted(self, pages, shared, in_use, free):
        """Page grant: emits the page_wait span (if the gate ever
        refused) and the zero-duration page_alloc marker."""
        now = now_us()
        if self._page_t0 is not None:
            self._child("page_wait", self._page_t0, now - self._page_t0,
                        attrs={"pages": int(pages)})
            self._page_t0 = None
        self._child("page_alloc", now, 0.0,
                    attrs={"pages": int(pages), "shared": int(shared),
                           "pool_in_use": int(in_use),
                           "pool_free": int(free)})

    def note_prefill(self, t0_us, dur_us, slot, batch, bucket, padding):
        self._child("prefill", t0_us, dur_us,
                    attrs={"slot": slot, "batch": int(batch),
                           "bucket": bucket, "padding": int(padding)})

    def note_batch(self, t0_us, dur_us, slot, batch, bucket, padding):
        """One-shot inference dispatch (the InferenceEngine's analog of
        prefill; the breakdown table folds it into the same column)."""
        self._child("batch", t0_us, dur_us,
                    attrs={"slot": slot, "batch": int(batch),
                           "bucket": bucket, "padding": int(padding)})

    def note_decode(self, t0_us, dur_us, slot, tick, active,
                    spec_accepted=None, spec_proposed=None):
        """One decode tick this request rode (slot id + speculation
        accept/reject counts when speculative)."""
        self.ticks += 1
        attrs = {"slot": slot, "tick": int(tick), "active": int(active)}
        if spec_proposed is not None:
            attrs["spec_accepted"] = int(spec_accepted)
            attrs["spec_proposed"] = int(spec_proposed)
        self._child("decode", t0_us, dur_us, attrs=attrs)

    def finish(self, status="ok", **attrs):
        """Terminal: emits the root span (idempotent — the first
        terminal decision wins, like the scheduler's own complete/fail
        races).  A still-open queue_wait (failed before admission)
        closes with the terminal status."""
        if self._done:
            return
        self._done = True
        now = now_us()
        if self._queue_open:
            self._queue_open = False
            self._child("queue_wait", self._queue_t0,
                        now - self._queue_t0, status=status)
        if attrs:
            self._attrs.update(attrs)
        self._attrs["ticks"] = self.ticks
        _emit("request", self.trace_id, self.root_id,
              self.root_parent_id, self._t0, now - self._t0,
              status=status, attrs=self._attrs, ts=self._ts)


# ---------------------------------------------------------------------------
# assembly + breakdown (one table, two consumers: tools/request_trace.py
# CLI over JSONL, bench rungs over the in-process buffer)
# ---------------------------------------------------------------------------

_TERMINAL = ("ok", "failed", "expired", "quarantined", "cancelled",
             "error")


def assemble(records):
    """Group ``trace_span`` records into per-trace trees.

    Returns ``{trace_id: tree}`` where tree is a dict with ``spans``
    (deduped by span_id, terminal status preferred over ``open``),
    ``root`` (the parentless span, or None), and ``complete`` — root
    present with a terminal status AND every parent link resolves
    inside the tree."""
    by_trace = {}
    for rec in records:
        if rec.get("event") != "trace_span" or not rec.get("trace_id"):
            continue
        t = by_trace.setdefault(rec["trace_id"],
                                {"spans": {}, "root": None})
        sid = rec.get("span_id")
        prev = t["spans"].get(sid)
        # emit_open anchors re-emit on finish: keep the terminal record
        if prev is None or prev.get("status") == "open":
            t["spans"][sid] = rec
    trees = {}
    for tid, t in by_trace.items():
        spans_ = list(t["spans"].values())
        ids = set(t["spans"])
        roots = [s for s in spans_ if not s.get("parent_id")]
        root = roots[0] if roots else None
        links_ok = all(s.get("parent_id") in ids for s in spans_
                       if s.get("parent_id"))
        trees[tid] = {
            "trace_id": tid, "spans": spans_, "root": root,
            "complete": (root is not None
                         and root.get("status") in _TERMINAL
                         and links_ok and len(roots) == 1),
            "run_ids": sorted({s.get("run_id") for s in spans_
                               if s.get("run_id")}),
        }
    return trees


STAGES = ("route", "queue_wait", "padding", "page_wait", "prefill",
          "decode", "spec_reject", "other")


def breakdown(tree):
    """Per-request latency attribution in milliseconds, summing (by
    construction) to the root span's duration:

    * ``queue_wait`` / ``page_wait`` — their spans' durations;
    * ``prefill`` — prefill/batch dispatch time, minus the ``padding``
      share (pad tokens / bucket: the compute the request's padding
      wasted);
    * ``decode`` — the ticks the request rode, minus the
      ``spec_reject`` share (rejected draft positions / verify window:
      the speculation work the target threw away);
    * ``route`` — fleet routing decisions (the ``rpc/route`` client
      legs of a fleet-dispatched request; zero for direct dispatch);
    * ``other`` — the unattributed remainder (host bookkeeping, loop
      scheduling gaps; for fleet trees also the data-plane RPC legs).

    Returns None for non-request trees: the root must be a ``request``
    (engine-direct) or ``fleet_request`` (fleet-routed — the engine's
    ``request`` span is then a CHILD inside the same tree, and its
    children attribute exactly once)."""
    root = tree.get("root")
    if root is None or root.get("name") not in ("request",
                                                "fleet_request"):
        return None
    lat = float(root.get("dur_ms") or 0.0)
    out = {k: 0.0 for k in STAGES}
    for s in tree["spans"]:
        name = s.get("name")
        dur = float(s.get("dur_ms") or 0.0)
        a = s.get("attrs") or {}
        if name == "rpc/route":
            out["route"] += dur
        elif name == "queue_wait":
            out["queue_wait"] += dur
        elif name == "page_wait":
            out["page_wait"] += dur
        elif name in ("prefill", "batch"):
            bucket = a.get("bucket") or 0
            pad = min(a.get("padding") or 0, bucket)
            pad_ms = dur * pad / bucket if bucket else 0.0
            out["padding"] += pad_ms
            out["prefill"] += dur - pad_ms
        elif name == "decode":
            k = a.get("spec_proposed")
            if k:
                rej = k - (a.get("spec_accepted") or 0)
                rej_ms = dur * rej / (k + 1)
                out["spec_reject"] += rej_ms
                out["decode"] += dur - rej_ms
            else:
                out["decode"] += dur
    attributed = sum(out.values())
    out["other"] = max(0.0, lat - attributed)
    return {"trace_id": tree["trace_id"],
            "request_id": (root.get("attrs") or {}).get("request_id"),
            "status": root.get("status"), "latency_ms": lat,
            "attributed_ms": round(attributed, 4),
            "stages": {k: round(v, 4) for k, v in out.items()}}


def _pctl(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def breakdown_summary(trees):
    """Aggregate stage percentiles over every complete request tree
    (the ``--json`` schema bench embeds)."""
    rows = [breakdown(t) for t in trees.values()]
    rows = [r for r in rows if r is not None]
    done = [r for r in rows if r["status"] in _TERMINAL]
    complete = [r for r in rows
                if trees[r["trace_id"]]["complete"]]
    stages = {}
    for st in STAGES:
        vals = sorted(r["stages"][st] for r in complete)
        stages[st] = {
            "p50_ms": round(_pctl(vals, 0.50), 4) if vals else None,
            "p99_ms": round(_pctl(vals, 0.99), 4) if vals else None,
            "mean_ms": round(sum(vals) / len(vals), 4) if vals else None,
        }
    lats = sorted(r["latency_ms"] for r in complete)
    return {"requests": len(rows), "terminal": len(done),
            "complete": len(complete),
            "complete_fraction": (round(len(complete) / len(done), 4)
                                  if done else None),
            "p50_latency_ms": _pctl(lats, 0.50),
            "p99_latency_ms": _pctl(lats, 0.99),
            "stages": stages}


def render_table(summary):
    """The human-facing latency-breakdown table."""
    lines = ["%-12s %12s %12s %12s" % ("stage", "p50(ms)", "p99(ms)",
                                       "mean(ms)")]
    for st in STAGES:
        s = summary["stages"][st]
        lines.append("%-12s %12s %12s %12s" % (
            st, *("%.3f" % s[k] if s[k] is not None else "-"
                  for k in ("p50_ms", "p99_ms", "mean_ms"))))
    lines.append(
        "%d requests (%d terminal, %d complete trees); latency p50 %s "
        "p99 %s ms" % (
            summary["requests"], summary["terminal"],
            summary["complete"],
            "%.3f" % summary["p50_latency_ms"]
            if summary["p50_latency_ms"] is not None else "-",
            "%.3f" % summary["p99_latency_ms"]
            if summary["p99_latency_ms"] is not None else "-"))
    return "\n".join(lines)


# -- chrome-trace request lanes ---------------------------------------------

# request lanes render in their own synthetic process group so Perfetto
# shows one lane per request next to (not interleaved with) the host
# thread lanes; the offset keeps the synthetic pid clear of real pids
_LANE_PID_OFFSET = 1000000


def chrome_events(max_lanes=64):
    """Buffered spans as chrome-trace events: one lane (synthetic tid)
    per trace, under a dedicated 'serving requests' process.  Returns
    ``(events, meta)`` for export_chrome_tracing to merge; timestamps
    share the profiler's perf_counter base, so request lanes line up
    with the host spans they explain."""
    from . import run_id

    trees = assemble(_spans)
    pid = os.getpid() + _LANE_PID_OFFSET
    events, meta = [], []
    ordered = sorted(trees.values(),
                     key=lambda t: min((s.get("mono_us") or 0)
                                       for s in t["spans"]))
    if not ordered:
        return [], []
    meta.append({"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": "paddle_tpu_torch serving requests",
                          "run_id": run_id()}})
    for lane, tree in enumerate(ordered[:max_lanes]):
        tid = lane + 1
        root = tree.get("root") or {}
        label = (root.get("attrs") or {}).get("request_id") \
            or tree["trace_id"]
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid,
                     "args": {"name": "req %s [%s]"
                              % (label, tree["trace_id"][:8])}})
        for s in tree["spans"]:
            ev = {"name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                  "ts": s.get("mono_us") or 0.0,
                  "dur": (s.get("dur_ms") or 0.0) * 1000.0,
                  "args": {"trace_id": s.get("trace_id"),
                           "span_id": s.get("span_id"),
                           "status": s.get("status")}}
            if s.get("attrs"):
                ev["args"].update(s["attrs"])
            events.append(ev)
    return events, meta
