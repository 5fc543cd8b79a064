"""Runtime flags (counterpart of ``paddle_tpu/flags.py``): a typed registry
whose values come from the flag's default, the environment at import
(``FLAGS_<name>=...``) or ``set_flags`` at run time.

Only the flags the port reads are registered: ``bn_two_pass`` (exact
two-pass batch-norm variance instead of the one-pass form shifted by the
running mean; ``batch_norm``, ``batch_stats`` and ``fuse_conv_bn`` read
it).
"""

import os
import threading

__all__ = ["flag", "set_flags", "register_flag"]

_mu = threading.Lock()
_FLAGS = {}
_TYPES = {}


def _parse(s, typ):
    if typ is bool:
        return s.strip().lower() in ("1", "true", "yes", "on")
    return typ(s)


def register_flag(name, default, typ=None):
    """Declare a flag; ``FLAGS_<name>`` in the environment overrides the
    default."""
    typ = typ or type(default)
    _TYPES[name] = typ
    env = os.environ.get("FLAGS_" + name)
    _FLAGS[name] = _parse(env, typ) if env is not None else default


def _name(key):
    name = key[6:] if key.startswith("FLAGS_") else key
    if name not in _FLAGS:
        raise KeyError("unknown flag %r" % key)
    return name


def set_flags(flags):
    """``set_flags({"FLAGS_bn_two_pass": True})``; the bare name works
    too."""
    with _mu:
        for k, v in flags.items():
            name = _name(k)
            typ = _TYPES[name]
            _FLAGS[name] = _parse(v, typ) if isinstance(v, str) else typ(v)


def flag(name):
    return _FLAGS[name]


register_flag("bn_two_pass", False, bool)
