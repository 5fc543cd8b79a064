"""Deterministic fault injection (counterpart of ``paddle_tpu/fault.py``).

Named **injection points** fire at set moments of the runtime, and
**schedules** decide, as a pure function of the step index (and a seed),
whether a registered fault fires there.  Two runs with the same schedule
inject at the same points, so a fault drill is a regression test and not
a chaos experiment.

Injection points (``fire`` costs one module-global bool read when nothing
is registered):

==========================  ================================================
point                       context / when
==========================  ================================================
``executor/feed``           after the feeds are taken as tensors, before
                            they reach the device; ctx ``feed_names`` and
                            the mutable ``feed_vals`` list (poison a batch)
``executor/dispatch``       just before the step runs or replays (delay or
                            fail a dispatch)
``executor/step_done``      after the step's write-back; ctx ``scope``,
                            ``state_names``, ``fetch_names`` and the
                            mutable ``fetches`` list (NaN into a named var)
``checkpoint/before_write`` start of the TrainState write protocol
``checkpoint/after_write``  payload written, manifest not yet
``checkpoint/before_commit`` manifest written, commit rename not yet (a
                            kill here leaves a torn ``.tmp`` artifact)
==========================  ================================================

The executor fires the ``executor/*`` points with its 0-based run counter
as ``step``, as the JAX executors do; the checkpoint points fire with the
artifact's step.  The drill families (``inject_nan``, ``poison_batch``,
``delay_dispatch``, ``fail_dispatch``, ``kill_mid_save``) are helpers over
``register``; ``FLAGS_fault_spec`` installs drills with no code
(``install_from_spec``).  Values are tensors here: a poisoned feed or a
NaN-filled var keeps its dtype, shape and device.

Every firing is recorded in the in-process log (``injections()``),
counted in ``fault/injections`` and logged as a ``fault_injected`` JSONL
event when the monitor is on.
"""

import hashlib
import os
import signal as _signal
import threading
import time

import numpy as np
import torch

from . import flags

__all__ = [
    "FaultSchedule", "FaultInjectedError",
    "register", "unregister", "clear", "active", "fire", "hooks",
    "injections", "clear_injections",
    "inject_nan", "poison_batch", "delay_dispatch", "fail_dispatch",
    "kill_mid_save", "install_from_spec",
]


class FaultInjectedError(RuntimeError):
    """Raised by the ``fail_dispatch`` drill family: a deliberately
    injected dispatch failure (distinct from any real error so tests
    and recovery policies can tell the drill from the disease)."""


def _unit_hash(seed, step):
    """Deterministic uniform [0, 1) from (seed, step): the schedule's
    probabilistic form is a pure function of its indices, never of a
    process's random state."""
    h = hashlib.sha256(b"%d:%d" % (int(seed), int(step))).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultSchedule:
    """When a fault fires, as a pure function of the step index.

    Three composable forms (a step fires if ANY matches):

    * ``steps`` — an explicit collection of step indices;
    * ``every``/``start`` — periodic: every ``every``-th step from
      ``start`` on;
    * ``prob``/``seed`` — pseudo-random: step ``s`` fires iff
      ``hash(seed, s) < prob``; the hash is a pure function of
      ``(seed, step)``, so two runs with the same seed fire at
      identical steps (seed/step-indexed determinism, test-enforced).

    The schedule object holds no runtime state — ``fires(step)`` is
    referentially transparent.  One-shot semantics (a transient fault
    that must not re-fire when rolled-back steps replay) live on the
    registered hook (``register(once=True)``), not here.
    """

    def __init__(self, steps=(), every=0, start=0, prob=0.0, seed=None):
        self.steps = frozenset(int(s) for s in steps)
        self.every = int(every)
        self.start = int(start)
        self.prob = float(prob)
        self.seed = int(flags.flag("fault_seed") if seed is None else seed)
        if self.prob < 0 or self.prob > 1:
            raise ValueError("prob must be in [0, 1], got %r" % prob)
        if not self.steps and not self.every and not self.prob:
            raise ValueError(
                "empty FaultSchedule would never fire: give steps=, "
                "every=, or prob=")

    def fires(self, step):
        step = int(step)
        if step in self.steps:
            return True
        if self.every > 0 and step >= self.start \
                and (step - self.start) % self.every == 0:
            return True
        if self.prob > 0 and _unit_hash(self.seed, step) < self.prob:
            return True
        return False

    def __repr__(self):
        parts = []
        if self.steps:
            parts.append("steps=%s" % sorted(self.steps))
        if self.every:
            parts.append("every=%d from %d" % (self.every, self.start))
        if self.prob:
            parts.append("prob=%g seed=%d" % (self.prob, self.seed))
        return "FaultSchedule(%s)" % ", ".join(parts)


class _Hook:
    def __init__(self, point, fn, schedule, name, once):
        self.point = point
        self.fn = fn
        self.schedule = schedule
        self.name = name
        self.once = bool(once)
        self.spent = False      # once-hooks disarm after their first firing

    def __repr__(self):
        return "<fault hook %r at %r %s%s>" % (
            self.name, self.point, self.schedule,
            " (spent)" if self.spent else "")


_mu = threading.Lock()
_REGISTRY = {}                  # point -> [_Hook]
_SPEC_HOOKS = []                # hooks installed by the latest fault_spec
# the fast-path gate: executors read this one module-global bool per
# step when no faults are registered (the disabled-is-free contract,
# same shape as monitor._enabled)
_ACTIVE = False
# in-process injection log [(point, step, name)] — the determinism
# test's ground truth: two runs with the same schedules produce
# identical logs
_LOG = []


def active():
    """True iff any fault hook is registered (module-global bool)."""
    return _ACTIVE


def hooks(point=None):
    """Registered hooks, optionally filtered by point (diagnostics)."""
    with _mu:
        if point is not None:
            return list(_REGISTRY.get(point, ()))
        return [h for hs in _REGISTRY.values() for h in hs]


def register(point, fn, schedule, name=None, once=False):
    """Register ``fn(step, **ctx)`` to run at ``point`` whenever
    ``schedule.fires(step)``.  ``once=True`` disarms the hook after its
    first firing — the transient-fault form: a rolled-back-and-replayed
    step does not re-trip it (replay would otherwise detect->recover->
    re-inject forever; the budget-exhausted abort is tested separately
    with a persistent hook).  Returns the hook handle for
    ``unregister``."""
    global _ACTIVE
    if not isinstance(schedule, FaultSchedule):
        raise TypeError("schedule must be a FaultSchedule, got %r"
                        % type(schedule).__name__)
    h = _Hook(point, fn, schedule, name or getattr(fn, "__name__", point),
              once)
    with _mu:
        _REGISTRY.setdefault(point, []).append(h)
        _ACTIVE = True
    return h


def unregister(hook):
    global _ACTIVE
    with _mu:
        hs = _REGISTRY.get(hook.point, [])
        if hook in hs:
            hs.remove(hook)
        if not hs:
            _REGISTRY.pop(hook.point, None)
        _ACTIVE = any(_REGISTRY.values())


def clear():
    """Remove every registered fault hook (tests; drill teardown)."""
    global _ACTIVE
    with _mu:
        _REGISTRY.clear()
        del _SPEC_HOOKS[:]
        _ACTIVE = False


def injections():
    """The injection log: [(point, step, hook name)] in firing order."""
    with _mu:
        return list(_LOG)


def clear_injections():
    with _mu:
        del _LOG[:]


def fire(point, step, **ctx):
    """Run every armed hook registered at ``point`` whose schedule fires
    at ``step``.  Near-free when nothing is registered (one bool read —
    callers may also pre-check ``active()``).  Hook exceptions
    propagate: a drill that raises (fail_dispatch) is *supposed* to
    surface in the training loop."""
    if not _ACTIVE:
        return
    with _mu:
        hs = list(_REGISTRY.get(point, ()))
    for h in hs:
        if h.spent or not h.schedule.fires(step):
            continue
        # record + disarm BEFORE running: kill_mid_save/fail_dispatch
        # never return, and a replayed once-fault must stay disarmed
        # even when its firing raised.  The flip side of this ordering
        # is a contract on hooks: a hook that cannot inject (misaimed
        # drill) must RAISE, never silently no-op — otherwise the log
        # would claim an injection that never happened.
        if h.once:
            h.spent = True
        with _mu:
            _LOG.append((point, int(step), h.name))
        _note_injection(point, step, h.name)
        h.fn(step, **ctx)


def _note_injection(point, step, name):
    from . import monitor

    monitor.count("fault/injections")
    if monitor.enabled():
        monitor.log_event({"event": "fault_injected", "ts": time.time(),
                           "point": point, "step": int(step),
                           "fault": name})


# ---------------------------------------------------------------------------
# drill families
# ---------------------------------------------------------------------------

def _floatish(dtype):
    """True for a floating dtype, torch's (bfloat16 included) or numpy's."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(dtype, np.floating) or "float" in str(dtype)


def _filled(v, fill, what):
    """A value like ``v`` (tensor or array: dtype, shape, device) filled
    with ``fill``.  An integral ``v`` takes only an integral ``fill`` (a
    TypeError otherwise: NaN has no integer)."""
    dtype = v.dtype if isinstance(v, torch.Tensor) else np.asarray(v).dtype
    if not _floatish(dtype) and not float(fill).is_integer():
        raise TypeError("cannot %s of non-float dtype %s with %r"
                        % (what, dtype, fill))
    if isinstance(v, torch.Tensor):
        return torch.full_like(v, fill if v.is_floating_point()
                               else int(fill))
    a = np.asarray(v)
    return np.full(a.shape, fill, a.dtype)


def _nan_like(v):
    return _filled(v, float("nan"), "NaN-fill a var")


def inject_nan(var_name, schedule, once=True, name=None):
    """Poison the named variable with NaN at scheduled steps — after the
    step completes, in the scope (a persistable var: params, optimizer
    slots) and/or the step's fetch list (a loss).  ``once=True`` by
    default: the canonical transient fault (an SDC blip, a bad
    collective) that a rollback recovers from because the replay is
    clean."""

    def _inject(step, scope=None, fetch_names=(), fetches=None, **_):
        hit = False
        if fetches is not None and var_name in fetch_names:
            i = list(fetch_names).index(var_name)
            fetches[i] = _nan_like(fetches[i])
            hit = True
        if scope is not None and scope.has_var(var_name):
            scope.set_var(var_name, _nan_like(scope.var(var_name)))
            hit = True
        if not hit:
            raise KeyError(
                "inject_nan: %r is neither a fetch of this step nor a "
                "scope var (typo in the drill spec?)" % var_name)

    return register("executor/step_done", _inject, schedule,
                    name=name or "nan_var:%s" % var_name, once=once)


def poison_batch(feed_name, schedule, once=False, fill=float("nan"),
                 name=None):
    """Corrupt the named feed at scheduled steps, before staging.  The
    default NaN fill makes the loss non-finite *in-graph*, which is
    exactly what the guardian's in-graph sentinel must catch; a finite
    ``fill`` (e.g. 1e30) drills the loss-spike detector instead.  An
    integer feed (ids, lengths) takes an integral ``fill``, not NaN: a
    sequence model's ``<target>@LEN`` filled with 0 leaves its loss no
    token to average over, so the loss is 0/0.  ``once=False`` by
    default: poisoned *data* is poisoned every time the reader yields
    it, so a replay that does not skip the batch deterministically
    re-trips."""

    def _poison(step, feed_names=(), feed_vals=None, **_):
        if feed_vals is None:
            return
        # misaimed drills fail LOUDLY (like inject_nan's KeyError): a
        # silent no-op would be recorded as an injection and let a
        # recovery test pass against a run that was never faulted
        if feed_name not in feed_names:
            raise KeyError(
                "poison_batch: %r is not a feed of this step (feeds: "
                "%s; typo in the drill spec?)"
                % (feed_name, sorted(feed_names)))
        i = list(feed_names).index(feed_name)
        feed_vals[i] = _filled(feed_vals[i], fill,
                               "poison_batch: fill feed %r" % feed_name)

    return register("executor/feed", _poison, schedule,
                    name=name or "poison_batch:%s" % feed_name, once=once)


def delay_dispatch(seconds, schedule, once=False, name=None):
    """Stall the dispatch path for ``seconds`` at scheduled steps — the
    slow-host / contended-interconnect drill the watchdog's stall
    detection (and the guardian's escalation) trains against."""
    seconds = float(seconds)

    def _delay(step, **_):
        time.sleep(seconds)

    return register("executor/dispatch", _delay, schedule,
                    name=name or "delay_dispatch:%gs" % seconds, once=once)


def fail_dispatch(schedule, once=True, name=None):
    """Raise ``FaultInjectedError`` from the dispatch path at scheduled
    steps — the hard-failure drill (device wedge, RPC loss)."""

    def _fail(step, **_):
        raise FaultInjectedError(
            "injected dispatch failure at step %d" % step)

    return register("executor/dispatch", _fail, schedule,
                    name=name or "fail_dispatch", once=once)


def kill_mid_save(schedule, point="before_commit", sig=_signal.SIGKILL,
                  name=None, once=True):
    """SIGKILL the process at the named point of the checkpoint write
    protocol: the preemption-mid-save drill, which must leave a torn
    ``.tmp`` artifact that restores ignore.
    ``point``: before_write | after_write | before_commit.  ``once``
    only matters for a non-SIGKILL ``sig`` or a respawning supervisor:
    the default kill never returns to disarm anything."""
    if point not in ("before_write", "after_write", "before_commit"):
        raise ValueError("unknown checkpoint point %r" % point)

    def _kill(step, **_):
        os.kill(os.getpid(), sig)

    return register("checkpoint/" + point, _kill, schedule,
                    name=name or "kill_mid_save:%s" % point, once=once)


# ---------------------------------------------------------------------------
# FLAGS_fault_spec: drills with no code changes
# ---------------------------------------------------------------------------

_SPEC_FAMILIES = ("nan_var", "poison_batch", "delay", "fail_dispatch",
                  "kill_save")


def _parse_schedule(text):
    """``"7"`` / ``"7,9"`` / ``"every=4"`` / ``"every=4+2"`` (start=2) /
    ``"prob=0.1"``."""
    text = text.strip()
    if text.startswith("every="):
        body = text[len("every="):]
        if "+" in body:
            every, start = body.split("+", 1)
            return FaultSchedule(every=int(every), start=int(start))
        return FaultSchedule(every=int(body))
    if text.startswith("prob="):
        return FaultSchedule(prob=float(text[len("prob="):]))
    return FaultSchedule(steps=[int(s) for s in text.split(",") if s])


def install_from_spec(spec):
    """Install drills from a ``FLAGS_fault_spec`` string — the env/flag
    entry point that makes drills first-class on ANY run:

        FLAGS_fault_spec="nan_var:fc_0.w_0@5;poison_batch:x@7,9"
        FLAGS_fault_spec="kill_save:before_commit@11"
        FLAGS_fault_spec="delay:0.2@every=8;fail_dispatch:@prob=0.01"

    Grammar: ``family:arg@schedule[:once|:persist]`` joined by ``;``.
    Schedules: explicit steps (``5`` / ``5,9``), ``every=N[+start]``,
    ``prob=P`` (seeded by ``FLAGS_fault_seed``).  Families default to
    their helper's once-ness (nan_var/fail/kill once, poison/delay
    persistent); ``:once``/``:persist`` override.

    REPLACES whatever a previous spec installed: re-applying a spec is
    idempotent (no duplicate hooks), a new spec swaps the drills, and
    an empty spec disarms them — the installed fault state always
    mirrors the flag value.  Transactional: a malformed entry leaves
    the previous spec's hooks untouched.  Hooks registered directly
    (``register``/drill helpers) are never touched.  Returns the list
    of installed hooks."""
    installed = []
    try:
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                head, sched_text = part.split("@", 1)
                family, _, arg = head.partition(":")
                once = None
                for suffix, val in ((":once", True), (":persist", False)):
                    if sched_text.endswith(suffix):
                        sched_text = sched_text[: -len(suffix)]
                        once = val
                sched = _parse_schedule(sched_text)
                family = family.strip()
                if family not in _SPEC_FAMILIES:
                    raise ValueError("unknown fault family %r (know: %s)"
                                     % (family, ", ".join(_SPEC_FAMILIES)))
                if family == "nan_var":
                    h = inject_nan(arg, sched,
                                   once=True if once is None else once)
                elif family == "poison_batch":
                    h = poison_batch(arg, sched,
                                     once=False if once is None else once)
                elif family == "delay":
                    h = delay_dispatch(float(arg), sched,
                                       once=False if once is None else once)
                elif family == "fail_dispatch":
                    h = fail_dispatch(sched,
                                      once=True if once is None else once)
                else:  # kill_save
                    h = kill_mid_save(sched, point=arg or "before_commit",
                                      once=True if once is None else once)
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(
                    "FLAGS_fault_spec entry %r is malformed: %s "
                    "(grammar: family:arg@schedule[:once|:persist])"
                    % (part, e))
            installed.append(h)
    except Exception:
        for h in installed:
            unregister(h)
        raise
    for h in _SPEC_HOOKS:
        unregister(h)
    _SPEC_HOOKS[:] = installed
    return installed


def _install_env_spec():
    """An env-set FLAGS_fault_spec observed during flag registration is
    installed here, at the end of this module's import: the flag's
    on_set hook fires while this module may still be mid-import
    (fault -> flags -> hook) and defers to us."""
    try:
        spec = flags.flag("fault_spec")
    except KeyError:            # flags module itself mid-registration
        return
    if str(spec).strip() and not _REGISTRY:
        install_from_spec(spec)


_install_env_spec()
