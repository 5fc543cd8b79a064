"""Scope: the runtime store of variable values (counterpart of
``paddle_tpu/scope.py``).  Values are ``torch.Tensor``s on the executor's
device; the map is a plain dict with parent lookup.  A scope keeps the
kid scopes made from it (``new_scope``) until ``drop_kids``."""

import contextlib

__all__ = ["Scope", "global_scope", "scope_guard"]


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        self.kids = []

    def new_scope(self):
        """A kid scope that looks names up in this one."""
        kid = Scope(parent=self)
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        self.kids = []

    def set_var(self, name, value):
        self._vars[name] = value

    def has_var(self, name):
        return self.find_var(name) is not None

    def find_var(self, name):
        """Find in this scope or its ancestors."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def var(self, name):
        v = self.find_var(name)
        if v is None:
            raise KeyError("variable %r not found in scope" % name)
        return v

    def local_var_names(self):
        return list(self._vars.keys())

    def __contains__(self, name):
        return self.has_var(name)


_global_scope = Scope()


def global_scope():
    return _global_scope


def _switch_scope(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    return prev


@contextlib.contextmanager
def scope_guard(scope):
    """Temporarily swap the global scope."""
    prev = _switch_scope(scope)
    try:
        yield
    finally:
        _switch_scope(prev)
