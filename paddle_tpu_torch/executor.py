"""Executor: runs a Program's global block eagerly on a Place's device
(counterpart of ``paddle_tpu/executor.py``).

``Executor.run(program, feed, fetch_list, scope)`` classifies the
program's variables as the JAX executor's ``_analyze`` does — feeds,
state read from the scope, persistable outputs written back — then
interprets the ops in program order (the JAX executor's
``trace_program`` loop, without the trace: there is no jit, every op
computes when it is reached) and writes the persistable outputs back to
the scope.  A variable that is neither persistable nor fetched is dropped
right after its last reader, so a training step holds each activation
only until its gradient op has used it (XLA frees buffers the same way
inside the JAX package's compiled step).  An op none of whose outputs is
read by a later op, fetched or persistable is dead and skipped, as XLA
eliminates dead code inside that step (``fuse_conv_bn`` re-emits a
``bn_apply`` and a ``relu`` for every batch norm it absorbs, and relies
on it); the ops that run keep their program index as ``op_index``, which
seeds their random draws and keys ``ComputeContext.saved``.  State that
an op updates in place (the KV cache, the optimizer's parameters and
moments) stays the same tensor across runs; the JAX package got the same
effect from buffer donation.

Places carry a ``torch.device``.  ``CUDAPlace(i)`` is the i-th card;
``CPUPlace()`` is the host, used only when the caller asks for it (the
tests do).  ``Executor()`` with no place runs on ``CUDAPlace(0)``.
"""

import numpy as np
import torch

from . import registry
from .framework import Variable, default_main_program
from .registry import ComputeContext
from .scope import global_scope

__all__ = ["Executor", "CPUPlace", "CUDAPlace"]


class Place:
    device = None

    def __repr__(self):
        return self.__class__.__name__


class CPUPlace(Place):
    device = torch.device("cpu")

    def __eq__(self, other):
        return isinstance(other, CPUPlace)

    def __hash__(self):
        return hash("CPUPlace")


class CUDAPlace(Place):
    """The i-th CUDA card."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)
        self.device = torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return isinstance(other, CUDAPlace) \
            and other.device_id == self.device_id

    def __hash__(self):
        return hash(("CUDAPlace", self.device_id))

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


def _to_device(value, device, dtype=None):
    """A feed or scope value as a tensor on ``device`` (of ``dtype`` when
    given)."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device=device, dtype=dtype)


class Executor:
    """Runs Programs on a Place."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self._run_counter = 0
        self._analysis = {}

    def _analyze(self, program, feed_names, scope, fetch_names):
        """Split program vars into feeds / state-from-scope / write-back
        (the JAX executor's ``_analyze``), mark the live ops, and list the
        temporaries each live op is the last to touch."""
        block = program.global_block()
        produced = set(feed_names)
        state = []
        for op in block.ops:
            for n in op.input_arg_names:
                if n and n not in produced and n not in state:
                    if scope.has_var(n):
                        state.append(n)
                    else:
                        raise RuntimeError(
                            "input var %r of op %r is neither fed, produced "
                            "by an earlier op, nor present in the scope. "
                            "Feed it or run the startup program first."
                            % (n, op.type))
            produced.update(n for n in op.output_arg_names if n)
        for n in fetch_names:
            if n and n not in produced and n not in state \
                    and scope.has_var(n):
                state.append(n)
        writeback = []
        for op in block.ops:
            for n in op.output_arg_names:
                v = block._find_var_recursive(n) if n else None
                if v is not None and v.persistable and n not in writeback:
                    writeback.append(n)
        # live[i]: op i writes a variable that a later live op reads, that
        # is fetched or that is persistable (an op with no outputs stays)
        needed = set(fetch_names) | set(writeback)
        live = [False] * len(block.ops)
        for i in reversed(range(len(block.ops))):
            op = block.ops[i]
            outs = [n for n in op.output_arg_names if n]
            if not outs or any(n in needed for n in outs):
                live[i] = True
                needed.update(n for n in op.input_arg_names if n)
        # release[i]: the temporaries whose last reader or writer is op i
        keep = set(writeback) | set(fetch_names) | set(state)
        last = {}
        for i, op in enumerate(block.ops):
            if not live[i]:
                continue
            for n in op.input_arg_names + op.output_arg_names:
                if n and n not in keep:
                    last[n] = i
        release = [[] for _ in block.ops]
        for n, i in last.items():
            release[i].append(n)
        return state, writeback, live, release

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Execute ``program``: ``feed`` maps names to arrays or tensors,
        ``fetch_list`` holds Variables or names; persistable results are
        written back to ``scope``.  Fetches come back as numpy arrays, or
        as tensors on the device with ``return_numpy=False``."""
        if program is None:
            program = default_main_program()
        feed = dict(feed or {})
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        feed_names = sorted(feed)
        dev = self.place.device
        block = program.global_block()

        key = (id(program), program._version, tuple(feed_names),
               tuple(fetch_names), id(scope))
        analysis = self._analysis.get(key)
        if analysis is None:
            analysis = self._analysis[key] = self._analyze(
                program, feed_names, scope, fetch_names)
        state_names, writeback, live, release = analysis

        env = {}
        for n in feed_names:
            v = block._find_var_recursive(n)
            env[n] = _to_device(feed[n], dev,
                                v.dtype if v is not None else None)
        for n in state_names:
            val = scope.var(n)
            if not isinstance(val, torch.Tensor) or val.device != dev:
                val = _to_device(val, dev)
                scope.set_var(n, val)
            env[n] = val

        seed = program.random_seed or int(np.random.randint(0, 2 ** 31 - 1))
        ctx = ComputeContext(dev, seed=seed, run_index=self._run_counter)
        self._run_counter += 1
        for i, op in enumerate(block.ops):
            if not live[i]:
                continue
            registry.compute_op(op, env, ctx, op_index=i)
            for n in release[i]:
                env.pop(n, None)
        for n in writeback:
            scope.set_var(n, env[n])

        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        return fetches


def _to_numpy(t):
    # numpy has no bfloat16: widen to float32 on the way out
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()
