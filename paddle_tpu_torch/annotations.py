"""API deprecation annotation (a copy of ``paddle_tpu/annotations.py``,
which the port cannot import: that package imports JAX)."""

import functools
import warnings

__all__ = ["deprecated"]


def deprecated(since, instead, extra_message=""):
    """Mark an API as deprecated since a version, pointing at the
    replacement.  Emits a DeprecationWarning once per call site (the
    reference prints to stderr on every call)."""

    def decorator(func):
        msg = "API %s is deprecated since %s. Please use %s instead." % (
            func.__name__, since, instead)
        if extra_message:
            msg += " " + extra_message

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        if wrapper.__doc__:
            wrapper.__doc__ += "\n\n    " + msg
        else:
            wrapper.__doc__ = msg
        return wrapper

    return decorator
