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
  a CUDA-graph capture (``monitor/program_profile.py``).
"""

import os
import threading

__all__ = ["flag", "set_flags", "get_flags", "register_flag"]

_mu = threading.Lock()
_FLAGS = {}
_TYPES = {}


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
    if on_set is not None and env is not None:
        on_set(_FLAGS[name])


def _name(key):
    name = key[6:] if key.startswith("FLAGS_") else key
    if name not in _FLAGS:
        raise KeyError("unknown flag %r" % key)
    return name


def set_flags(flags):
    """``set_flags({"FLAGS_bn_two_pass": True})``; the bare name works
    too.  A flag whose hook raises keeps its previous value, and the hook
    runs again with it so that what the hook configures matches."""
    with _mu:
        for k, v in flags.items():
            name = _name(k)
            typ, on_set = _TYPES[name]
            v = _parse(v, typ) if isinstance(v, str) else typ(v)
            prev = _FLAGS[name]
            _FLAGS[name] = v
            if on_set is None:
                continue
            try:
                on_set(v)
            except Exception:
                _FLAGS[name] = prev
                try:
                    on_set(prev)
                except Exception:  # noqa: BLE001 — the first error wins
                    pass
                raise


def get_flags(names):
    """``get_flags("FLAGS_check_nan_inf")`` or a list; returns a dict."""
    if isinstance(names, str):
        names = [names]
    return {k: _FLAGS[_name(k)] for k in names}


def flag(name):
    return _FLAGS[name]


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
