"""String and number compatibility helpers (a copy of
``paddle_tpu/compat.py``, which the port cannot import: that package
imports JAX): ``to_text`` / ``to_bytes`` normalize str and bytes
(through list, set and dict containers), ``round`` rounds half away
from zero, and ``floor_division`` and ``get_exception_message`` keep
their names."""

import math

__all__ = [
    "int_type", "long_type", "to_text", "to_bytes", "round",
    "floor_division", "get_exception_message",
]

int_type = int
long_type = int


def _convert(obj, conv, inplace):
    if obj is None or isinstance(obj, (int, float)):
        return obj
    if isinstance(obj, (str, bytes)):
        return conv(obj)
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_convert(x, conv, inplace) for x in obj]
            return obj
        return [_convert(x, conv, False) for x in obj]
    if isinstance(obj, set):
        new = {_convert(x, conv, False) for x in obj}
        if inplace:
            obj.clear()
            obj.update(new)
            return obj
        return new
    if isinstance(obj, dict):
        new = {_convert(k, conv, False): _convert(v, conv, False)
               for k, v in obj.items()}
        if inplace:
            obj.clear()
            obj.update(new)
            return obj
        return new
    return obj    # reference behavior: unknown types pass through untouched


def to_text(obj, encoding="utf-8", inplace=False):
    """Anything string-like (recursively through list/set/dict) -> str."""
    return _convert(
        obj, lambda s: s.decode(encoding) if isinstance(s, bytes) else s,
        inplace)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """Anything string-like (recursively through list/set/dict) -> bytes."""
    return _convert(
        obj, lambda s: s.encode(encoding) if isinstance(s, str) else s,
        inplace)


def round(x, d=0):  # noqa: A001 — reference shadows the builtin
    """Half-away-from-zero rounding (py2 semantics; py3's builtin
    rounds half to even)."""
    p = 10 ** d
    if x > 0:
        return float(math.floor((x * p) + math.copysign(0.5, x))) / p
    if x < 0:
        return float(math.ceil((x * p) + math.copysign(0.5, x))) / p
    return 0.0


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    assert exc is not None
    return str(exc)
