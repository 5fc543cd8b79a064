"""Runtime flags (counterpart of ``paddle_tpu/flags.py``): a typed registry
whose values come from the flag's default, the environment at import
(``FLAGS_<name>=...``) or ``set_flags`` at run time.  A flag may carry an
``on_set`` hook, run when the environment sets it at import and on every
``set_flags``; a hook that raises leaves the previous value in place.

Only the flags the port reads are registered, with the JAX package's
defaults:

* ``bn_two_pass``: exact two-pass batch-norm variance instead of the
  one-pass form shifted by the running mean (``batch_norm``,
  ``batch_stats`` and ``fuse_conv_bn`` read it);
* ``check_nan_inf``: after every executor step, the floating fetches and
  written-back state are checked and the first non-finite variable is
  named in a RuntimeError, with the step;
* ``benchmark``: the executor prints each step's wall time, taken after a
  ``torch.cuda.synchronize`` on a CUDA place;
* the monitor family (``monitor``, ``monitor_log_dir``, ``monitor_port``,
  ``monitor_console_seconds``, ``monitor_stall_seconds``): any of the
  first four turns the monitor on (``monitor/__init__.py``);
* ``trace``: per-request tracing (``monitor/tracing.py``);
* ``health`` and ``health_every``: the per-layer health probe inside the
  step and its publication cadence (``monitor/health.py``);
* ``preflight_oom`` and ``preflight_hbm_bytes``: the memory check before
  a CUDA-graph capture (``monitor/program_profile.py``);
* the guardian family (``guardian``, ``guardian_policy``,
  ``guardian_window``, ``guardian_zmax``, ``guardian_max_skips``,
  ``guardian_max_rollbacks``, ``guardian_quarantine_dir``,
  ``guardian_spike_action``, ``guardian_plateau_steps``,
  ``guardian_stall_escalations``): the training-run guardian
  (``guardian.py``) and the executor's in-graph skip guard;
* the fault family (``fault_seed``, ``fault_spec``): deterministic
  fault-injection drills installed from a spec string (``fault.py``);
* ``max_inflight_steps``: how many unread steps the guardian may hold
  before it reads the oldest;
* the autotune family (``autotune_dir``, ``autotune_hbm_bytes``,
  ``autotune_overhead_budget``, ``quantize_mode``,
  ``quantize_accuracy_budget``): where the tuner's decision tables live,
  its memory ceiling, the checkpoint-overhead budget and the quantization
  gate (``autotune.py``);
* ``compile_cache_dir``: the persistent kernel-library directory
  (``compile_cache.enable_persistent_cache``).

**Pins.**  A flag set from the environment, or by ``set_flags`` with the
default ``pin=True``, is pinned: the operator chose it, and a tuned
decision never overrides it (``pinned``).  Machinery that sets a flag on
the operator's behalf (the tuner's own arms, restore paths) passes
``pin=False``; ``_restore_pins`` puts back a saved set.  The port has no
flag that selects a kernel (the JAX package's ``pallas_kernels``), so
only ``quantize_mode`` pins a tuned decision here.
"""

import os
import threading

__all__ = ["flag", "set_flags", "get_flags", "register_flag", "pinned"]

_mu = threading.Lock()
_FLAGS = {}
_TYPES = {}
# the flags the operator set explicitly (see the module docstring)
_PINNED = set()


def _parse(s, typ):
    if typ is bool:
        return s.strip().lower() in ("1", "true", "yes", "on")
    return typ(s)


def register_flag(name, default, typ=None, on_set=None):
    """Declare a flag; ``FLAGS_<name>`` in the environment overrides the
    default (and runs ``on_set``)."""
    typ = typ or type(default)
    _TYPES[name] = (typ, on_set)
    env = os.environ.get("FLAGS_" + name)
    _FLAGS[name] = _parse(env, typ) if env is not None else default
    if env is not None:
        _PINNED.add(name)
    if on_set is not None and env is not None:
        on_set(_FLAGS[name])


def _name(key):
    name = key[6:] if key.startswith("FLAGS_") else key
    if name not in _FLAGS:
        raise KeyError("unknown flag %r" % key)
    return name


def set_flags(flags, pin=True):
    """``set_flags({"FLAGS_bn_two_pass": True})``; the bare name works
    too.  A flag whose hook raises keeps its previous value, and the hook
    runs again with it so that what the hook configures matches.
    ``pin=True`` marks each flag the operator's choice (``pinned``)."""
    with _mu:
        for k, v in flags.items():
            name = _name(k)
            typ, on_set = _TYPES[name]
            v = _parse(v, typ) if isinstance(v, str) else typ(v)
            prev = _FLAGS[name]
            _FLAGS[name] = v
            if on_set is not None:
                try:
                    on_set(v)
                except Exception:
                    _FLAGS[name] = prev
                    try:
                        on_set(prev)
                    except Exception:  # noqa: BLE001 — the first error wins
                        pass
                    raise
            if pin:
                _PINNED.add(name)


def get_flags(names):
    """``get_flags("FLAGS_check_nan_inf")`` or a list; returns a dict."""
    if isinstance(names, str):
        names = [names]
    return {k: _FLAGS[_name(k)] for k in names}


def flag(name):
    return _FLAGS[name]


def pinned(name):
    """Whether the operator set this flag (the environment at import, or
    ``set_flags`` with ``pin=True``): a tuned decision never overrides
    it."""
    return _name(name) in _PINNED


def _restore_pins(mapping):
    """Restore a saved ``{name: was_pinned}``."""
    with _mu:
        for name, was in mapping.items():
            (_PINNED.add if was else _PINNED.discard)(_name(name))


def _on_monitor_change(_val):
    # one hook for the FLAGS_monitor* family: the monitor re-reads every
    # flag and starts, stops or reconfigures what changed
    from . import monitor

    monitor._reconcile()


def _on_trace_change(_val):
    from .monitor import tracing

    tracing._reconcile()


def _on_health_change(_val):
    from .monitor import health

    health._reconcile()


def _on_preflight_oom(val):
    # a typo ("stric") must not downgrade the hard-fail mode to a warning
    allowed = ("auto", "warn", "strict", "off", "0", "false", "no",
               "none", "")
    if str(val).strip().lower() not in allowed:
        raise ValueError(
            "FLAGS_preflight_oom must be one of auto/warn/strict/off, "
            "got %r" % (val,))
    from .monitor import program_profile

    program_profile._on_preflight_flag(val)


register_flag("bn_two_pass", False, bool)
register_flag("check_nan_inf", False, bool)
register_flag("benchmark", False, bool)
register_flag("monitor", False, bool, _on_monitor_change)
register_flag("monitor_log_dir", "", str, _on_monitor_change)
register_flag("monitor_port", 0, int, _on_monitor_change)
register_flag("monitor_console_seconds", 0.0, float, _on_monitor_change)
register_flag("monitor_stall_seconds", 120.0, float, _on_monitor_change)
register_flag("trace", False, bool, _on_trace_change)
register_flag("health", False, bool, _on_health_change)
register_flag("health_every", 10, int, _on_health_change)
register_flag("preflight_oom", "auto", str, _on_preflight_oom)
# capacity in bytes for the preflight (0: the card's free memory)
register_flag("preflight_hbm_bytes", 0, int)


def _on_guardian_policy(val):
    # a typo'd rung ("rolback") silently dropping rollback from the ladder
    # would defeat the operator's intent
    bad = {t.strip() for t in str(val).split(",") if t.strip()} \
        - {"skip", "rollback", "abort"}
    if bad:
        raise ValueError(
            "FLAGS_guardian_policy tokens must be among "
            "skip/rollback/abort, got %s" % sorted(bad))


def _on_guardian_spike_action(val):
    if str(val).strip() not in ("warn", "rollback", "off"):
        raise ValueError(
            "FLAGS_guardian_spike_action must be warn/rollback/off, "
            "got %r" % (val,))


def _on_fault_spec(val):
    # drills straight from the environment or set_flags: install_from_spec
    # replaces the previous spec's hooks, so the installed drills mirror
    # the flag; an empty value disarms them (nothing to disarm when
    # fault.py was never imported)
    import sys

    if not str(val).strip():
        fault = sys.modules.get(__name__.rsplit(".", 1)[0] + ".fault")
        if fault is not None and hasattr(fault, "install_from_spec"):
            fault.install_from_spec("")
        return
    from . import fault

    if not hasattr(fault, "install_from_spec"):
        # the environment set it while fault.py is mid-import (fault ->
        # flags -> this hook): fault installs the spec at the end of its
        # module body
        return
    fault.install_from_spec(val)


# the guardian's master switch: with it on the Trainer installs a
# Guardian and, when "skip" is on the ladder, each executor entry carries
# the in-graph skip guard (the guard keys the entry)
register_flag("guardian", False, bool)
register_flag("guardian_policy", "skip,rollback,abort", str,
              _on_guardian_policy)
register_flag("guardian_window", 32, int)
register_flag("guardian_zmax", 8.0, float)
register_flag("guardian_max_skips", 8, int)
register_flag("guardian_max_rollbacks", 2, int)
register_flag("guardian_quarantine_dir", "", str)
register_flag("guardian_spike_action", "warn", str, _on_guardian_spike_action)
register_flag("guardian_plateau_steps", 0, int)
register_flag("guardian_stall_escalations", 3, int)
# the guardian reads a step's verdict once it is ready, or once more than
# this many steps wait unread (the JAX package's dispatch window)
register_flag("max_inflight_steps", 8, int)
# registered before fault_spec: an environment spec installs schedules at
# import, which read it
register_flag("fault_seed", 0, int)
register_flag("fault_spec", "", str, _on_fault_spec)


def _on_quantize_mode(val):
    if str(val).strip() not in ("", "off", "weight_only", "dynamic"):
        raise ValueError(
            "FLAGS_quantize_mode must be one of ''/off/weight_only/"
            "dynamic, got %r" % (val,))


def _on_compile_cache_dir(val):
    from . import compile_cache

    compile_cache.enable_persistent_cache(val)


# the tuner (autotune.py): where TunedConfig artifacts and the decision
# tables live ("": the tables stay in memory), the memory ceiling of the
# batch ladder in bytes (0: FLAGS_preflight_hbm_bytes, then the card's
# total), and the checkpoint-overhead budget (CheckFreq)
register_flag("autotune_dir", "", str)
register_flag("autotune_hbm_bytes", 0, int)
register_flag("autotune_overhead_budget", 0.035, float)
# an explicit mode is the operator's choice ("off" pins full precision;
# "" leaves it to tune_quantization); the gate keeps a quantized program
# only under this relative-L1 eval delta
register_flag("quantize_mode", "", str, _on_quantize_mode)
register_flag("quantize_accuracy_budget", 0.02, float)
# the kernel libraries' directory, kept across processes (compile_cache)
register_flag("compile_cache_dir", "", str, _on_compile_cache_dir)
