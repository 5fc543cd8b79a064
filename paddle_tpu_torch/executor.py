"""Executor: runs a Program's global block on a Place's device
(counterpart of ``paddle_tpu/executor.py``).

``Executor.run(program, feed, fetch_list, scope)`` classifies the
program's variables as the JAX executor's ``_analyze`` does — feeds,
state read from the scope, persistable outputs written back — then
interprets the ops in program order (the JAX executor's
``trace_program`` loop) and writes the persistable outputs back to the
scope.  A variable that is neither persistable nor fetched is dropped
right after its last reader, so a training step holds each activation
only until its gradient op has used it (XLA frees buffers the same way
inside the JAX package's compiled step).  An op none of whose outputs is
read by a later op, fetched or persistable is dead and skipped, as XLA
eliminates dead code inside that step (``fuse_conv_bn`` re-emits a
``bn_apply`` and a ``relu`` for every batch norm it absorbs, and relies
on it); the ops that run keep their program index as ``op_index``, which
keys their attention-dropout seeds and ``ComputeContext.saved``.  State
that an op updates in place (the KV cache, the optimizer's parameters and
moments) stays the same tensor across runs; the JAX package got the same
effect from buffer donation.

**The compiled step.**  The JAX executor jit-compiles each (program, feed
signature) once.  Here each entry — (program, its version, the feeds'
names, shapes and dtypes, the fetch names, the program's AMP policy, the
scope) — runs eagerly the first time (which builds the kernels, picks
cuDNN's algorithms and sizes the workspaces), and on a CUDA place the
second run captures the step as one CUDA graph (``torch.cuda.CUDAGraph``,
on the executor's side stream, ``capture_error_mode="thread_local"``
because the serving engines run their loop on a thread of their own) and
replays it; every later run replays it.  The graph holds the live ops,
the release of temporaries and the grad ops' ``torch.autograd.grad``
recompute.  Around it:

* feeds: each entry owns one device buffer a feed; a run copies the feed
  into it on the current stream, the one that then replays the graph:
  from numpy through a pinned staging buffer (``non_blocking``), from a
  CUDA tensor (a ``DevicePrefetcher`` batch, ready on this stream when it
  was handed out) device to device;
* state: the graph reads and writes the scope's own tensors.  A
  persistable output that an op returns as a new tensor (``increment``,
  the batch-norm running statistics) is copied into the state tensor at
  the end of the graph, so no scope value lives in the graph's memory
  pool.  Before a replay every bound name is checked by identity; a value
  put in the scope since (``io.load_*``, ``scope.set_var``, numpy) is
  copied into the captured tensor and the scope pointed back at it, and
  one of another shape or dtype sends the entry back to the cold path;
* fetches: ``return_numpy=False`` returns clones, which a later run does
  not change;
* randomness: the executor owns one ``torch.Generator`` for each program
  seed on its device (``random_seed`` 0: one seed drawn once from numpy),
  registered with every graph that captures such a program, so a replay
  advances it as the eager run does; no run reads a host seed
  (``ComputeContext``);
* kernel launch counts: each wrapper counts the launches it makes from
  the host, and a run that captures makes them once (into the graph); a
  replay runs the graph, not the wrappers, and counts nothing, so a
  replayed step's launches are read from a device trace
  (``ops.cuda.device_launch_counts``).

A SelectedRows gradient (an ``is_sparse`` table's, ``ops/selected_rows``)
is a value of the run's environment like a tensor: freed after its last
reader, captured and replayed with the step; a fetch of one returns it as
the JAX executor does (``_to_numpy``).

An entry lives as long as its program and its scope: when either dies,
the entry, its graph and the tensors the graph holds are dropped at the
executor's next run.

A capture that fails raises, naming the op that broke it; nothing falls
back to the eager path.  ``Executor(place, capture=False)`` keeps every
run eager on the card (the comparison path, as ``jax.disable_jit``);
``CPUPlace()`` always runs eagerly.

**Memory.**  An executor's graphs share one memory pool.  That is safe
because no pool tensor has to keep its value past the end of the run that
wrote it: state lives in the scope's tensors outside the pool, feed
buffers are allocated outside it, and each run consumes its fetch outputs
(to numpy, or cloned) before it returns; replays of one executor are
serial (``run`` holds a lock) on one stream.  So a graph may reuse, as its
temporaries, memory that another graph of the executor used or returns,
and ResNet-50's three programs or the serving buckets need the largest
step's memory rather than the sum.

Places carry a ``torch.device``.  ``CUDAPlace(i)`` is the i-th card;
``CPUPlace()`` is the host, used only when the caller asks for it (the
tests do).  ``Executor()`` with no place runs on ``CUDAPlace(0)``.
"""

import threading
import weakref

import numpy as np
import torch

from . import registry
from .framework import Variable, default_main_program
from .ops.selected_rows import SelectedRows
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


def _as_tensor(value):
    """A feed or scope value as a tensor (numpy arrays without a copy)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _to_device(value, device, dtype=None):
    """A feed or scope value as a tensor on ``device`` (of ``dtype`` when
    given)."""
    return _as_tensor(value).to(device=device, dtype=dtype)


def _scope_tensor(scope, name, device):
    """The scope's value of ``name`` as a tensor on ``device``; a value
    still elsewhere (numpy, another device) is moved and put back."""
    val = scope.var(name)
    if not isinstance(val, torch.Tensor) or val.device != device:
        val = _to_device(val, device)
        scope.set_var(name, val)
    return val


def _interpret(block, live, release, env, ctx, where=None):
    """Compute the live ops in program order, dropping each temporary after
    its last reader; ``where[0]`` names the op being computed."""
    for i, op in enumerate(block.ops):
        if not live[i]:
            continue
        if where is not None:
            where[0] = "op %d (%s)" % (i, op.type)
        registry.compute_op(op, env, ctx, op_index=i)
        for n in release[i]:
            env.pop(n, None)


def _entry_died(exe_ref, key, analysis):
    """``weakref.finalize`` callback: the program or the scope of an entry
    died.  The executor drops the entry at the start of its next run, not
    here, where a collection in the middle of a capture may have called
    this."""
    exe = exe_ref()
    if exe is not None:
        exe._dead.append((key, analysis))


class _StaticFeed:
    """One feed's device buffer in a captured step, and its pinned
    staging buffer for host values."""

    def __init__(self, shape, dtype, device):
        with torch.inference_mode(False):
            self.buffer = torch.empty(shape, dtype=dtype, device=device)
        self._host = None
        self._copied = None

    def load(self, value):
        """Copy ``value`` into the buffer on the current stream, the one
        that replays the graph."""
        if isinstance(value, torch.Tensor) and value.device.type == "cuda":
            self.buffer.copy_(value)
            return
        if self._host is None:
            with torch.inference_mode(False):
                self._host = torch.empty(self.buffer.shape,
                                         dtype=self.buffer.dtype,
                                         pin_memory=True)
            self._copied = torch.cuda.Event()
        else:
            # the previous run's copy out of the staging buffer is done
            self._copied.synchronize()
        self._host.copy_(value)
        self.buffer.copy_(self._host, non_blocking=True)
        self._copied.record()


class _CapturedStep:
    """An entry's CUDA graph and the tensors it was captured on."""

    def __init__(self, out_meta):
        # (shape, dtype) of each persistable output, from the eager run
        self.out_meta = out_meta
        self.graph = None
        self.feeds = {}      # feed name -> _StaticFeed
        self.bound = {}      # scope name -> the tensor the graph uses
        self.reads = set()   # the bound names the graph reads
        self.fetches = []    # the fetched tensors the graph writes

    def bind(self, scope):
        """Point the scope at the captured tensors before a replay,
        copying in any value put there since; False when one no longer
        fits (another shape or dtype)."""
        for n, t in self.bound.items():
            cur = scope.find_var(n)
            if cur is t:
                continue
            if n in self.reads:
                if cur is None:
                    raise RuntimeError(
                        "var %r, which the program reads, is no longer in "
                        "the scope" % n)
                cur = _as_tensor(cur)
                if tuple(cur.shape) != tuple(t.shape) \
                        or cur.dtype != t.dtype:
                    return False
                t.copy_(cur)
            scope.set_var(n, t)
        return True


class Executor:
    """Runs Programs on a Place; on a CUDA place with ``capture`` (the
    default) each entry's steps from the second on replay a CUDA graph."""

    def __init__(self, place=None, capture=True):
        self.place = place if place is not None else CUDAPlace(0)
        self.capture = bool(capture)
        self._analysis = {}
        self._steps = {}
        self._dead = []      # (key, analysis) of entries whose owner died
        self._generators = {}
        self._lock = threading.RLock()
        self._stream = None
        self._pool = None

    def _generator(self, seed):
        """The executor's generator for programs of ``seed`` (0: one seed
        drawn once from numpy's global generator, as the JAX executor
        draws it)."""
        g = self._generators.get(seed)
        if g is None:
            g = torch.Generator(device=self.place.device)
            g.manual_seed(int(seed) or int(np.random.randint(0, 2 ** 31 - 1)))
            self._generators[seed] = g
        return g

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
        # the forward ops whose generic grad op runs (registry keep_graph)
        graph_ops = frozenset(
            op.attrs["__fwd_op_index__"] for i, op in enumerate(block.ops)
            if live[i] and "__fwd_type__" in op.attrs
            and "__fwd_op_index__" in op.attrs)
        return state, writeback, live, release, graph_ops

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Execute ``program``: ``feed`` maps names to arrays or tensors,
        ``fetch_list`` holds Variables or names; persistable results are
        written back to ``scope``.  Fetches come back as numpy arrays, or
        as tensors on the device with ``return_numpy=False``."""
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        block = program.global_block()
        feed = {n: _as_tensor(v) for n, v in (feed or {}).items()}
        feed_names = sorted(feed)
        # each feed's shape and the dtype it enters the program with: one
        # entry (and one graph) per signature, as the JAX executor keys
        # its jit cache by feed_sig
        feed_dtypes = {}
        for n in feed_names:
            v = block._find_var_recursive(n)
            feed_dtypes[n] = (v.dtype if v is not None and v.dtype is not None
                              else feed[n].dtype)
        # the AMP policy changes what every op computes without a version
        # bump (bf16_program_guard), so it keys the entry too (policies
        # compare by their lists)
        key = (id(program), program._version,
               tuple((n, tuple(feed[n].shape), feed_dtypes[n])
                     for n in feed_names),
               tuple(fetch_names), program._amp_policy, id(scope))
        with self._lock:
            self._drop_dead()
            analysis = self._analysis.get(key)
            if analysis is None:
                analysis = self._analysis[key] = self._analyze(
                    program, feed_names, scope, fetch_names)
                # reported when either owner dies, which is before another
                # program or scope can take its id
                for owner in (program, scope):
                    weakref.finalize(owner, _entry_died, weakref.ref(self),
                                     key, analysis).atexit = False
            if not (self.capture and self.place.device.type == "cuda"):
                fetches = self._run_eager(program, analysis, feed,
                                          feed_dtypes, scope, fetch_names)
            else:
                with torch.cuda.device(self.place.device):
                    fetches = self._run_captured(
                        key, program, analysis, feed, feed_dtypes, scope,
                        fetch_names)
                    if not return_numpy:
                        # a later replay rewrites the graph's outputs
                        fetches = [_clone(f) for f in fetches]
            if return_numpy:
                fetches = [_to_numpy(f) for f in fetches]
        return fetches

    def _drop_dead(self):
        """Drop the entries whose program or scope died."""
        synced = False
        while self._dead:
            key, analysis = self._dead.pop()
            if self._analysis.get(key) is not analysis:
                continue
            del self._analysis[key]
            step = self._steps.pop(key, None)
            if step is not None and step.graph is not None and not synced:
                # a replay of the graph may still be running
                torch.cuda.synchronize(self.place.device)
                synced = True

    def _run_eager(self, program, analysis, feed, feed_dtypes, scope,
                   fetch_names, out_meta=None):
        """Interpret the live ops one by one; ``out_meta`` collects the
        persistable outputs' (shape, dtype)."""
        state_names, writeback, live, release, graph_ops = analysis
        dev = self.place.device
        block = program.global_block()
        env = {n: feed[n].to(device=dev, dtype=feed_dtypes[n]) for n in feed}
        env.update((n, _scope_tensor(scope, n, dev)) for n in state_names)
        _interpret(block, live, release, env, ComputeContext(
            dev, self._generator(program.random_seed), len(block.ops),
            program._amp_policy, program, graph_ops))
        for n in writeback:
            scope.set_var(n, env[n])
            if out_meta is not None:
                out_meta[n] = (tuple(env[n].shape), env[n].dtype)
        return [env[n] for n in fetch_names]

    def _run_captured(self, key, program, analysis, feed, feed_dtypes,
                      scope, fetch_names):
        step = self._steps.get(key)
        if step is not None and step.graph is not None \
                and not step.bind(scope):
            step = None   # the state changed shape or dtype: cold again
        if step is None:
            out_meta = {}
            fetches = self._run_eager(program, analysis, feed, feed_dtypes,
                                      scope, fetch_names, out_meta)
            self._steps[key] = _CapturedStep(out_meta)
            return fetches
        if step.graph is None:
            self._capture(step, program, analysis, feed, feed_dtypes, scope,
                          fetch_names)
        for n, f in step.feeds.items():
            f.load(feed[n])
        step.graph.replay()
        return step.fetches

    def _capture(self, step, program, analysis, feed, feed_dtypes, scope,
                 fetch_names):
        """Capture the entry's step into ``step.graph`` on the feeds' and
        the scope's current tensors; the caller replays it."""
        state_names, writeback, live, release, graph_ops = analysis
        dev = self.place.device
        block = program.global_block()
        for n in feed:
            step.feeds[n] = _StaticFeed(feed[n].shape, feed_dtypes[n], dev)
        step.bound = {n: _scope_tensor(scope, n, dev) for n in state_names}
        step.reads = set(state_names)
        for n in writeback:
            if n in step.bound:
                continue
            # a persistable the program writes without reading it: the
            # scope's tensor if it fits, else a new one outside the pool
            shape, dtype = step.out_meta[n]
            val = scope.find_var(n)
            if not (isinstance(val, torch.Tensor) and val.device == dev
                    and tuple(val.shape) == shape and val.dtype == dtype):
                with torch.inference_mode(False):
                    val = torch.empty(shape, dtype=dtype, device=dev)
                scope.set_var(n, val)
            step.bound[n] = val
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        generator = self._generator(program.random_seed)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        env = {n: f.buffer for n, f in step.feeds.items()}
        env.update((n, step.bound[n]) for n in state_names)
        ctx = ComputeContext(dev, generator, len(block.ops),
                             program._amp_policy, program, graph_ops)
        where = ["the start of the step"]
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                _interpret(block, live, release, env, ctx, where)
                where[0] = "the write-back of the persistable outputs"
                for n in writeback:
                    if env[n] is not step.bound[n]:
                        step.bound[n].copy_(env[n])
                step.fetches = [env[n] for n in fetch_names]
        except Exception as e:
            raise RuntimeError(
                "CUDA graph capture of program %d (version %d) failed at "
                "%s: %s" % (id(program), program._version, where[0], e)) \
                from e
        step.graph = graph


def _clone(f):
    if isinstance(f, SelectedRows):
        return SelectedRows(f.rows.clone(), f.values.clone(), f.height)
    return f.clone()


def _to_numpy(t):
    """A fetch on the host.  A SelectedRows comes back as the JAX executor
    returns it, in a 0-d object array, its rows and values numpy
    (``get_tensor_from_selected_rows`` gives the dense tensor)."""
    if isinstance(t, SelectedRows):
        sr = SelectedRows(_to_numpy(t.rows), _to_numpy(t.values), t.height)
        out = np.empty((), dtype=object)
        out[()] = sr
        return out
    # numpy has no bfloat16: widen to float32 on the way out
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.device.type == "cpu":
        # a CPU tensor's numpy() shares its memory, and state is updated
        # in place by later runs: the fetch is a copy, as from the card
        return t.detach().numpy().copy()
    return t.detach().cpu().numpy()
