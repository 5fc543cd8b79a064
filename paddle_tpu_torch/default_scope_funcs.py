"""A thread-local stack of default scopes (counterpart of
``paddle_tpu/default_scope_funcs.py``): its bottom is the global scope;
``enter_local_scope`` pushes a kid of the current scope,
``leave_local_scope`` pops it, ``var`` / ``find_var`` address the
current scope, and ``scoped_function`` runs a function inside a fresh
kid scope that is dropped afterwards.
"""

import threading

from .scope import global_scope

__all__ = [
    "get_cur_scope",
    "enter_local_scope",
    "leave_local_scope",
    "var",
    "find_var",
    "scoped_function",
]

__tl_scope__ = threading.local()


class _Unset(object):
    """Placeholder for a declared-but-unassigned variable slot (the
    reference's Scope::Var creates an empty Variable holder; this
    scope stores values directly, so declaration needs a sentinel)."""

    def __repr__(self):
        return "<unset var>"


_UNSET = _Unset()


def get_cur_scope():
    """The scope on top of this thread's stack (the bottom is the
    process-global scope, matching the reference's root scope)."""
    cur_scope_stack = getattr(__tl_scope__, "cur_scope", None)
    if cur_scope_stack is None:
        __tl_scope__.cur_scope = [global_scope()]
    return __tl_scope__.cur_scope[-1]


def enter_local_scope():
    """Push a new kid scope of the current scope."""
    cur_scope = get_cur_scope()
    new_scope = cur_scope.new_scope()
    __tl_scope__.cur_scope.append(new_scope)
    return new_scope


def leave_local_scope():
    """Pop and destroy the current local scope."""
    if len(__tl_scope__.cur_scope) <= 1:
        raise RuntimeError("cannot leave the root scope")
    __tl_scope__.cur_scope.pop()
    get_cur_scope().drop_kids()


def var(name):
    """Create (or get) a variable slot in the current scope."""
    scope = get_cur_scope()
    if not scope.has_var(name):
        scope.set_var(name, _UNSET)
    return scope.find_var(name)


def find_var(name):
    """Find a variable in the current scope or its parents."""
    return get_cur_scope().find_var(name)


def scoped_function(func):
    """Run ``func`` inside a fresh local scope (reference
    default_scope_funcs.scoped_function)."""
    enter_local_scope()
    try:
        return func()
    finally:
        leave_local_scope()
