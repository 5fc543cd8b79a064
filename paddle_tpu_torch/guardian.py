"""Training-run guardian (counterpart of ``paddle_tpu/guardian.py``):
anomaly sentinels and an automatic recovery ladder over the TrainState
checkpoints.

**Sentinels**

* the **in-graph skip guard**: when the ladder includes ``skip``, each
  executor entry (``executor.py``) checks its floating fetches inside the
  step and puts every state variable the step wrote back to its value
  before the step when one is not finite, so a poisoned batch never
  reaches the parameters, the moments or the LR and step counters;
* a **host-side sentinel** in ``note_step``: a non-finite loss the guard
  could not prevent (parameters already NaN, corruption injected on the
  host) escalates straight to rollback;
* a **rolling-window spike/plateau detector**: a median + MAD z-score
  over the last ``window`` finite losses; spikes publish events and may
  roll back (``spike_action``), plateaus publish events;
* **stall escalation** through ``monitor.add_stall_listener``: after
  ``stall_escalations`` watchdog stall windows with no completed step it
  arms an abort that the next observed step raises.

**Recovery ladder** (``policy``, default ``skip,rollback,abort``):

1. *skip*: the guard drops the update; the host quarantines the batch
   (an npz and its JSON sidecar under ``quarantine_dir``) and counts it.
   More than ``max_skips`` consecutive skips escalate.
2. *rollback*: ``GuardianRollback`` is raised; the training loop (the
   contrib Trainer, or any caller) restores the newest clean TrainState at or
   below the failure through ``rollback_restore`` (corrupt and
   NaN-poisoned artifacts are skipped), which rewinds the executor's run
   counter and generators and the reader's position, and fast-forwards
   the reader past the poisoned batches when the data is to blame.
3. *abort*: after ``max_rollbacks`` rollbacks, ``GuardianAbortError``.

Every decision is published as a ``guardian/*`` counter and a
``guardian_*`` JSONL event, stamped with the run id.  With the health
probe on, a quarantined step is replayed op by op
(``transpiler/nan_debug.py``) and the first op that made a non-finite
value is named in the sidecar, the event and the escalation's message.

The executor hands the guardian each step's verdict and loss as device
tensors; ``note_step`` reads them once the step is done on the card (a
CUDA event), or once more than ``FLAGS_max_inflight_steps`` steps wait, or
at once for a synchronous run, so the asynchronous path keeps its overlap.

With no guardian installed the executor reads one module global a step.
Cluster arbitration (the JAX package's ``ClusterGuardian``) waits for
ROADMAP A7c.
"""

import collections
import json
import os
import time
import warnings

import numpy as np
import torch

from . import flags

__all__ = [
    "Guardian", "GuardianRollback", "GuardianAbortError",
    "install", "uninstall", "active", "installed", "skip_guard_enabled",
]


class GuardianRollback(RuntimeError):
    """Control-flow signal: the guardian decided the run must roll back
    to the last clean checkpoint.  Carries the failing step index, the
    reason, and whether quarantined batches implicate the data (the
    replay then fast-forwards past the poisoned window)."""

    def __init__(self, step, reason, quarantined=False):
        super().__init__(
            "guardian: rollback requested at step %d (%s)" % (step, reason))
        self.step = int(step)
        self.reason = reason
        self.quarantined = bool(quarantined)


class GuardianAbortError(RuntimeError):
    """The recovery ladder is exhausted (rollback budget spent, no clean
    checkpoint, or watchdog-stall escalation): the run must stop with a
    typed error instead of looping or hanging."""


def _policy_tokens(policy=None):
    policy = policy if policy is not None else flags.flag("guardian_policy")
    return tuple(t.strip() for t in str(policy).split(",") if t.strip())


def skip_guard_enabled():
    """Whether executor entries carry the in-graph skip guard: the
    guardian flag is on and ``skip`` is in the ladder, the installed
    guardian's when one is (an instance ladder of ``rollback,abort`` must
    not leave a flag-level guard deciding otherwise), else
    ``FLAGS_guardian_policy``.  The executor keys its entries by it."""
    if not flags.flag("guardian"):
        return False
    g = _ACTIVE
    policy = g.policy if g is not None else _policy_tokens()
    return "skip" in policy


def warn_unobserved_skip_guard(executor):
    """Called by an executor whose step came back with a guard verdict
    while no guardian is installed to decide on it: non-finite updates
    are dropped on the device with no event, counter or budget.  Legal,
    but almost always a leaked ``FLAGS_guardian``; said once an
    executor."""
    if getattr(executor, "_warned_unobserved_guard", False):
        return
    executor._warned_unobserved_guard = True
    warnings.warn(
        "in-graph skip guard is active (FLAGS_guardian) but no "
        "guardian is installed: non-finite updates are dropped "
        "silently — install one (guardian.install / Trainer "
        "guardian_config) or clear FLAGS_guardian")


def _provenance_clause(prov):
    """Render a NaN-provenance record into an escalation-message clause
    ('' when provenance is unavailable or found nothing)."""
    if not prov or not prov.get("found"):
        return ""
    layer = prov.get("layer")
    return "; first non-finite op: %s -> %r (op #%d%s)" % (
        prov.get("op_type"), prov.get("out_var"),
        prov.get("op_index", -1),
        ", layer %s" % layer if layer else "")


def _finite(a):
    """Every element of a tensor or array finite (integral values always
    are)."""
    if isinstance(a, torch.Tensor):
        return not a.is_floating_point() or bool(torch.isfinite(a).all())
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        return True
    return bool(np.isfinite(a).all())


def _floating(v):
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    dt = getattr(v, "dtype", None)
    return dt is not None and np.issubdtype(np.dtype(dt), np.inexact)


def _host(v):
    """A feed value as a numpy array (bfloat16 widened to float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _step_event(*values):
    """A CUDA event recorded after the step that made ``values`` when one
    of them is on the card, else None (ready now)."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(v.device))
            return ev
    return None


class Guardian:
    """Per-run anomaly sentinel + recovery policy.  Construction reads
    the ``FLAGS_guardian_*`` family; kwargs override per-instance (the
    Trainer's ``guardian_config`` path).  ``install`` it (or pass it to
    the Trainer) to have every executor feed it each step."""

    def __init__(self, policy=None, window=None, zmax=None,
                 max_skips=None, max_rollbacks=None, quarantine_dir=None,
                 spike_action=None, plateau_steps=None,
                 stall_escalations=None, loss_name=None):
        self.policy = _policy_tokens(policy)
        bad = set(self.policy) - {"skip", "rollback", "abort"}
        if bad:
            raise ValueError("unknown guardian policy tokens %s "
                             "(know: skip, rollback, abort)" % sorted(bad))
        self.window = int(window if window is not None
                          else flags.flag("guardian_window"))
        self.zmax = float(zmax if zmax is not None
                          else flags.flag("guardian_zmax"))
        self.max_skips = int(max_skips if max_skips is not None
                             else flags.flag("guardian_max_skips"))
        self.max_rollbacks = int(
            max_rollbacks if max_rollbacks is not None
            else flags.flag("guardian_max_rollbacks"))
        self.quarantine_dir = (
            quarantine_dir if quarantine_dir is not None
            else flags.flag("guardian_quarantine_dir"))
        self.spike_action = str(
            spike_action if spike_action is not None
            else flags.flag("guardian_spike_action"))
        if self.spike_action not in ("warn", "rollback", "off"):
            raise ValueError("spike_action must be warn/rollback/off, "
                             "got %r" % self.spike_action)
        self.plateau_steps = int(
            plateau_steps if plateau_steps is not None
            else flags.flag("guardian_plateau_steps"))
        self.stall_escalations = int(
            stall_escalations if stall_escalations is not None
            else flags.flag("guardian_stall_escalations"))
        self.loss_name = loss_name
        self.reset_run_state()

    def reset_run_state(self):
        """Start a fresh run segment: detection history, budgets, and
        counters are PER-RUN — a Guardian instance reused across
        ``train()`` calls must not carry a spent rollback budget or an
        armed stall abort into the next run (the Trainer calls this
        when it re-installs a caller-provided instance)."""
        # deferred observations: (step, verdict, loss, feed, the event
        # after the step), drained when the step is done on the card or
        # when the deque outgrows the dispatch window, so the async path
        # keeps its overlap while decisions stay deterministic (the skip
        # itself already happened in the step)
        self._pending = collections.deque()
        # history must hold plateau_steps losses too: a plateau window
        # longer than the spike window would otherwise never fill and
        # the detector would be silently dead
        self._history = collections.deque(
            maxlen=max(4, self.window, self.plateau_steps))
        self._consecutive_skips = 0
        self._spike_run = 0          # consecutive spike-flagged steps
        self._rollbacks = 0
        self._stalls = 0
        self._stall_abort = None
        self._plateau_armed = True
        self.skipped_steps = 0
        self.quarantined = []        # [(step, reason)] this run segment
        # measured replay debt of the last rollback (failed step minus
        # restored step): the checkpoint-interval tuner's evidence
        self.last_replay_steps = None

    # -- executor hook -------------------------------------------------
    def note_step(self, executor_name, step, ok=None, fetch_names=(),
                  fetches=(), feed=None, sync=False):
        """One executor step completed.  ``ok`` is the in-graph guard's
        verdict handle (None when the guard is off), ``fetches`` the
        user-visible fetch values (device arrays on the async path),
        ``feed`` a ``(names, values)`` pair for quarantine.  Raises
        ``GuardianRollback``/``GuardianAbortError`` per the policy
        ladder — from inside ``run()``, so the training loop sees the
        decision at the step that made it observable."""
        if self._stall_abort is not None:
            reason, self._stall_abort = self._stall_abort, None
            raise GuardianAbortError(reason)
        self._stalls = 0            # a completed step re-arms escalation
        loss = self._watched_fetch(fetch_names, fetches)
        self._pending.append((int(step), ok, loss, feed,
                              _step_event(ok, loss)))
        self._drain(force=sync)

    def flush(self):
        """Force-process every deferred observation (epoch boundaries,
        end of run) — blocks on any not-yet-retired step handles.  The
        ladder's exceptions can raise from here."""
        self._drain(force=True)

    def _watched_fetch(self, fetch_names, fetches):
        if self.loss_name is not None:
            for n, f in zip(fetch_names, fetches):
                if n == self.loss_name:
                    return f
            return None
        for f in fetches:
            if _floating(f):
                return f
        return None

    def _max_pending(self):
        return max(1, int(flags.flag("max_inflight_steps")))

    def _drain(self, force):
        while self._pending:
            step, ok, loss, feed, done = self._pending[0]
            if not force and len(self._pending) <= self._max_pending() \
                    and done is not None and not done.query():
                return
            self._pending.popleft()
            self._process(step, ok, loss, feed)

    # -- decision core -------------------------------------------------
    def _process(self, step, ok, loss, feed):
        ok_v = None if ok is None else bool(ok)
        if ok_v is False:
            self._on_skip(step, feed)
            return
        if loss is not None and not _finite(loss):
            self._on_nonfinite(step, feed)
            return
        self._consecutive_skips = 0
        if loss is not None:
            self._observe_loss(step, float(np.mean(_host(loss).astype(
                np.float64))))

    def _on_skip(self, step, feed):
        self.skipped_steps += 1
        self._consecutive_skips += 1
        self._counter("guardian/skipped_steps")
        q = self._quarantine(step, feed, "nonfinite_in_graph")
        prov = self._provenance(step, q)
        self._event({"event": "guardian_skip", "step": step,
                     "consecutive": self._consecutive_skips,
                     "quarantine": q})
        if self._consecutive_skips > self.max_skips:
            self._escalate(step,
                           "%d consecutive in-graph skips exceed the "
                           "skip budget (%d)%s"
                           % (self._consecutive_skips, self.max_skips,
                              _provenance_clause(prov)),
                           quarantined=True)

    def _on_nonfinite(self, step, feed):
        q = self._quarantine(step, feed, "nonfinite_observed")
        prov = self._provenance(step, q)
        self._event({"event": "guardian_nonfinite", "step": step,
                     "quarantine": q})
        # the update already reached the scope (no in-graph guard, or
        # corruption past it): skipping cannot help — escalate
        self._escalate(step, "non-finite loss observed"
                       + _provenance_clause(prov), quarantined=False)

    def _provenance(self, step, q):
        """NaN provenance for a quarantined step: replay the quarantined
        batch op by op and name the first op that made a non-finite
        value.  The record is attached to the
        quarantine sidecar (JSON rewritten in place) and published as a
        ``guardian_nan_provenance`` event.  One health-module read when
        the probe is off; never raises — this runs on the abort path."""
        from .monitor import health

        if not health.enabled():
            return None
        try:
            # the stashed replay context holds the same feed values the
            # quarantine persisted
            prov = health.nan_provenance(step)
        except Exception:  # noqa: BLE001 — diagnostics must not mask
            return None
        if prov is None:
            return None
        q["provenance"] = prov
        if q.get("path"):
            try:
                with open(q["path"][: -len(".npz")] + ".json", "w") as f:
                    json.dump(q, f)
            except OSError:
                pass
        self._counter("guardian/nan_provenance")
        self._event(dict(prov, event="guardian_nan_provenance",
                         quarantine_path=q.get("path")))
        return prov

    def _observe_loss(self, step, loss):
        hist = self._history
        if len(hist) >= max(8, self.window // 2) and self.zmax > 0 \
                and self.spike_action != "off":
            # the deque may hold plateau_steps > window losses; the
            # spike baseline stays the last `window` of them
            base = np.asarray(list(hist)[-self.window:])
            med = float(np.median(base))
            mad = float(np.median(np.abs(base - med)))
            # the dispersion floor is RELATIVE to the loss scale: a
            # saturated window (MAD 0, e.g. a memorized or clamped
            # loss) must not turn float-noise fluctuations into
            # z ~ 1e4 spikes — below ~0.1% of the level there is no
            # anomaly to detect
            denom = 1.4826 * mad + 1e-4 * max(1.0, abs(med))
            # one-sided: only an UPWARD move is an anomaly — a sharp
            # improvement (LR-decay boundary, curriculum switch) is
            # healthy and enters the baseline like any other loss
            z = (loss - med) / denom
            floor = 1e-6 * max(1.0, abs(med))
            if z > self.zmax and loss - med > floor:
                self._spike_run += 1
                self._counter("guardian/loss_spikes")
                self._event({"event": "guardian_loss_spike", "step": step,
                             "loss": loss, "median": med, "mad": mad,
                             "z": round(z, 2), "action": self.spike_action})
                if self.spike_action == "rollback":
                    self._escalate(step,
                                   "loss spike z=%.1f (%.4g above %.4g "
                                   "over MAD %.4g)" % (z, loss, med, mad),
                                   quarantined=False)
                if self._spike_run <= max(2, self.window // 2):
                    return           # outliers stay out of the baseline
                # ... but boundedly: a level that persists for half a
                # window is the run's new regime, not a spike — restart
                # the baseline at it instead of flagging every remaining
                # step of the run against a frozen pre-shift median
                self._event({"event": "guardian_spike_baseline_reset",
                             "step": step, "loss": loss,
                             "outlier_run": self._spike_run})
                hist.clear()
                self._plateau_armed = True
            self._spike_run = 0
        hist.append(loss)
        self._check_plateau(step)

    def _check_plateau(self, step):
        n = self.plateau_steps
        if n <= 0 or len(self._history) < n:
            return
        recent = list(self._history)[-n:]
        first = float(np.median(recent[: n // 2]))
        second = float(np.median(recent[n // 2:]))
        improving = (first - second) > 1e-4 * max(1.0, abs(first))
        if improving:
            self._plateau_armed = True
        elif self._plateau_armed:
            self._plateau_armed = False    # fire once per plateau
            self._counter("guardian/plateaus")
            self._event({"event": "guardian_plateau", "step": step,
                         "window": n, "median_first_half": first,
                         "median_second_half": second})

    def _escalate(self, step, reason, quarantined):
        # abort and rollback messages carry the last per-layer health
        # snapshot: which layer was sick
        from .monitor import health

        snap = health.format_snapshot()
        if snap:
            reason = "%s [health %s]" % (reason, snap)
        if "rollback" in self.policy:
            raise GuardianRollback(step, reason, quarantined=quarantined)
        raise GuardianAbortError(
            "guardian: %s at step %d and the policy ladder %r has no "
            "rollback rung" % (reason, step, ",".join(self.policy)))

    # -- rollback protocol (driven by the Trainer or any caller) -------
    def begin_rollback(self, rb):
        """Charge one rollback against the budget (raises
        ``GuardianAbortError`` when exhausted) before any restore work
        starts — the budget bounds ATTEMPTS, not successes."""
        self._rollbacks += 1
        self._counter("guardian/rollbacks")
        if self._rollbacks > self.max_rollbacks:
            raise GuardianAbortError(
                "guardian: rollback budget (%d) exhausted at step %d "
                "(%s) — the fault persists across recoveries; aborting "
                "instead of looping" % (self.max_rollbacks, rb.step,
                                        rb.reason))

    def rollback_restore(self, manager, rb, scope=None, program=None,
                         executors=None, readers=None):
        """Restore the newest CLEAN TrainState at or below the failed
        step: artifacts that are corrupt (checksum) or poisoned
        (non-finite arrays — a checkpoint taken after the corruption
        landed) are skipped with an event; a structural mismatch still
        raises (configuration error, not a fault).  Returns the
        restored step or raises ``GuardianAbortError`` when no clean
        artifact exists.  The whole scan+restore runs under a
        ``guardian/rollback`` span: the goodput ledger books it (plus
        the replayed steps after it) as ``recovery`` badput."""
        from .profiler import RecordEvent

        with RecordEvent("guardian/rollback"):
            return self._rollback_restore(
                manager, rb, scope=scope, program=program,
                executors=executors, readers=readers)

    def _rollback_restore(self, manager, rb, scope=None, program=None,
                          executors=None, readers=None):
        from .parallel.checkpoint import CheckpointCorruptError

        candidates = [s for s in manager.all_steps() if s <= rb.step]
        for s in reversed(candidates):
            # validate WITHOUT applying: a rejected artifact must leave
            # no side effects — no scope mutation, no
            # checkpoint_restored event, no save-cadence reseed — and
            # the no-clean-artifact abort below must leave the
            # pre-rollback state in place.  A structural mismatch out
            # of restore() still raises (configuration error, not a
            # fault).
            try:
                ts = manager.load(s)
            except CheckpointCorruptError as e:
                self._event({"event": "guardian_checkpoint_skipped",
                             "step": s, "reason": "corrupt",
                             "detail": str(e)})
                continue
            if not all(_finite(a) for a in ts.arrays.values()):
                self._counter("guardian/poisoned_checkpoints")
                self._event({"event": "guardian_checkpoint_skipped",
                             "step": s, "reason": "nonfinite_state"})
                continue
            restored = manager.restore(
                step=s, scope=scope, program=program,
                executors=executors, readers=readers, train_state=ts)
            # the replay debt of this recovery: the steps between the
            # restored artifact and the failure, which a rollback runs
            # again
            self.last_replay_steps = max(0, int(rb.step) - int(restored))
            self._event({"event": "guardian_rollback", "step": rb.step,
                         "reason": rb.reason, "restored_step": restored,
                         "replay_steps": self.last_replay_steps,
                         "rollbacks": self._rollbacks,
                         "quarantined": rb.quarantined})
            return restored
        raise GuardianAbortError(
            "guardian: rollback requested at step %d (%s) but no clean "
            "checkpoint exists at or below it" % (rb.step, rb.reason))

    def post_restore(self, rb, restored_step):
        """Reset detection state after a successful restore and return
        how many batches the reader should fast-forward: past the
        poisoned window (``failed - restored`` batches, ending just
        after the quarantined batch) when the failure implicates the
        data, else 0 (transient fault: the replay re-consumes the same
        batches and — by the exact-resume contract — reproduces the
        clean trajectory)."""
        self._pending.clear()
        self._history.clear()
        self._consecutive_skips = 0
        self._spike_run = 0
        self._plateau_armed = True
        if rb.quarantined:
            return max(0, rb.step + 1 - int(restored_step))
        return 0

    # -- watchdog escalation -------------------------------------------
    def _on_stall(self, diag):
        """monitor stall-listener: called from the watchdog thread at
        each stall firing.  Arms an abort after ``stall_escalations``
        consecutive firings with no completed step; the next observed
        step raises it (a thread-safe flag — raising from the watchdog
        thread could not unwind the training loop anyway, and a FULLY
        wedged device needs the external supervisor either way)."""
        self._stalls += 1
        if self._stalls >= self.stall_escalations > 0 \
                and self._stall_abort is None:
            self._counter("guardian/stall_escalations")
            self._event({"event": "guardian_stall_escalated",
                         "stalls": self._stalls,
                         "stalled_for_s": diag.get("stalled_for_s")})
            self._stall_abort = (
                "guardian: watchdog reported %d consecutive stall "
                "windows (%.0fs each) with no completed step — pipeline "
                "wedged" % (self._stalls,
                            diag.get("stall_seconds", 0.0)))

    # -- quarantine ----------------------------------------------------
    def _quarantine(self, step, feed, reason):
        """Persist the offending batch + its feed signature for repro;
        returns the quarantine record (path None when no dir is
        configured — the event still carries the signature)."""
        from . import monitor

        self.quarantined.append((int(step), reason))
        self._counter("guardian/quarantined_batches")
        vals = None if feed is None else [_host(v) for v in feed[1]]
        # schema: feed_signature/feed_names for repro, provenance for
        # the first-offending-op record (filled in by _provenance after
        # the write; the sidecar JSON is rewritten in place then)
        rec = {"run_id": monitor.run_id(), "step": int(step),
               "reason": reason, "ts": time.time(), "path": None,
               "provenance": None}
        if feed is not None:
            names = feed[0]
            rec["feed_signature"] = [(n, list(v.shape), str(v.dtype))
                                     for n, v in zip(names, vals)]
            if self.quarantine_dir:
                os.makedirs(self.quarantine_dir, exist_ok=True)
                base = os.path.join(
                    self.quarantine_dir,
                    "batch_%s_step%08d" % (monitor.run_id(), int(step)))
                # positional npz members + a name list in the sidecar
                # (same scheme as TrainState artifacts: npz member names
                # can't carry '/' etc. across numpy versions)
                with open(base + ".npz", "wb") as f:
                    np.savez(f, **{"arr_%d" % i: v
                                   for i, v in enumerate(vals)})
                rec["feed_names"] = list(names)
                rec["path"] = base + ".npz"
                with open(base + ".json", "w") as f:
                    json.dump(rec, f)
        return rec

    # -- publication helpers -------------------------------------------
    @staticmethod
    def _counter(name):
        from . import monitor

        monitor.count(name)

    @staticmethod
    def _event(rec):
        from . import monitor

        rec.setdefault("ts", time.time())
        monitor.log_event(rec)

    def stats(self):
        return {"skipped_steps": self.skipped_steps,
                "rollbacks": self._rollbacks,
                "quarantined": len(self.quarantined),
                "pending": len(self._pending),
                "window": list(self._history)}


# ---------------------------------------------------------------------------
# process-global installation (the executors' one-read hook)
# ---------------------------------------------------------------------------

_ACTIVE = None


def active():
    """The installed Guardian, or None — the executors' per-step gate
    (one module-global read when no guardian is installed)."""
    return _ACTIVE


def install(g):
    """Install ``g`` as the process guardian: every executor feeds it
    each step, and it subscribes to watchdog stall firings.  Returns
    ``g``."""
    global _ACTIVE
    from . import monitor

    if _ACTIVE is not None and _ACTIVE is not g:
        monitor.remove_stall_listener(_ACTIVE._on_stall)
    _ACTIVE = g
    monitor.add_stall_listener(g._on_stall)
    return g


def uninstall():
    """Remove the installed guardian (its deferred observations are NOT
    flushed — call ``flush()`` first if the ladder should still fire)."""
    global _ACTIVE
    from . import monitor

    if _ACTIVE is not None:
        monitor.remove_stall_listener(_ACTIVE._on_stall)
    _ACTIVE = None


class installed:
    """Context manager: install ``g`` for the duration (no-op when
    ``g`` is None — the Trainer's disabled path)."""

    def __init__(self, g):
        self._g = g

    def __enter__(self):
        if self._g is not None:
            install(self._g)
        return self._g

    def __exit__(self, *exc):
        if self._g is not None and _ACTIVE is self._g:
            uninstall()
        return False
