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
health probe, the skip guard, the tuner's kernel rulings in force
(``compile_cache.trace_flag_values``), the scope) — runs eagerly the
first time (which builds the kernels, picks
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

An entry that holds a live op that calls the host on every run
(``registry.calls_host``: a ``print`` op, or a ``print_grad`` whose phase
prints) runs eagerly on every run and is never captured: a graph cannot
call the host, and a capture would print once.

**Loops read on the host.**  An unbounded ``while`` op (no
``max_trip_count``; ``registry.splits_capture``) reads its condition on
the host after every trip.  ``segment_plan``, a plain function of the
global block and its live ops, splits an entry at each such op: runs of
ops, and the loops between them.  The eager path runs the same segments,
so the CPU runs the split: a run of ops is interpreted, a loop runs one
predicated trip (``ops/control_flow.while_trip``) and reads the condition
on the host, until it is false.  A captured entry is one graph a run of
ops, and one body graph a loop: the graph before the loop ends by copying
the loop's initial values into static carry buffers, and the body graph
computes one trip over them, writes the new values back (a trip after
the condition fell changes no bit) and copies the condition into a
pinned host flag.  The executor replays the body graph, waits on an
event, reads the flag, and replays again until it is false: the only host
read is that one read a trip, outside every graph, so a captured run
gives the eager run's bits and trips.  ``loop_trips`` lists each loop's
trips in the last run, ``flag_reads`` counts the reads.  An unbounded
``while`` inside another op's sub-block (a ``while``, ``recurrent`` or
``conditional_block`` body) cannot be split out: a capturing executor
refuses the entry, naming the op; ``capture=False`` runs it eagerly.

A capture that fails raises, naming the op that broke it; nothing falls
back to the eager path.  ``Executor(place, capture=False)`` keeps every
run eager on the card (the comparison path, as ``jax.disable_jit``);
``CPUPlace()`` always runs eagerly.

**Memory.**  Before a capture, when the blocks the allocator caches
but no tensor holds outweigh the card's free memory (a warm-up near half
the card), they are returned, so that the capture's pool fits beside the
state.  An executor's graphs share one memory pool.  That is safe
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

**Observability.**  With the monitor or a profiler session on, a run
records the JAX executor's spans under the port's names:
``executor/analyze`` (a new entry's analysis and segment plan, where the
JAX package traces; none when another executor analyzed the same
program, signature and identity, whose analysis ``compile_cache`` keeps,
a ``compile_cache/hit`` or ``/miss`` mark either way), ``executor/run``
around the step span, which is ``executor/warmup`` for an entry's first
(eager) run, ``executor/capture``
for the run that captures and ``executor/dispatch`` for the others (args:
``run_id``, the program's fingerprint, the step and the goodput bucket),
``executor/h2d_transfer`` around the feeds' copies and
``executor/fetch_sync`` around the fetches' trip to the host.  No span,
counter or monitor call sits inside a captured graph: they wrap the
replay.  ``monitor.record_step`` ends the run; its ``warm`` is True when
the run replayed a graph it captured before (on a place that never
captures: when the entry existed).  The record's time ends when the
fetches reach the host; with ``return_numpy=False`` on the card nothing
waits for the device, and it ends at the replay's launch.  The first two
runs of an entry are profiled (``monitor.program_profile``): the warm-up's
peak memory, the capture's seconds and peak, and the first replay's
device time and launches, from CUDA events and a ``torch.profiler``
trace; the memory preflight runs before the capture.  With every flag off
a run reads the monitor's and the profiler's enabled bools and makes no
monitor call.

**Faults and the guardian.**  A run fires the fault points of
``fault.py`` where the JAX executor does (``executor/feed`` on the
feeds as tensors, ``executor/dispatch`` before the step,
``executor/step_done`` after the write-back, each with the run counter as
its step) and hands the installed guardian (``guardian.py``) its step
last.  With ``FLAGS_guardian`` and ``skip`` on the ladder an entry
carries the skip guard, which keys the entry: the step keeps a device copy
of every state variable it writes as it stood before the step, and at its
end, inside the graph, puts the copies back when a floating fetch (the
user's, not the probe's extras) is not finite; so a poisoned step leaves
the parameters, the moments and the LR and step counters bit-equal, and
its generator advances as on any step.  The verdict rides as a device
tensor to the guardian; nothing waits for it inside the run.
``state_dict`` / ``load_state_dict`` carry the run counter and every
generator's state, so an executor restored from a TrainState draws what
the uninterrupted one would, eager or replayed (a generator a graph
registered is set in place, and the graph draws from its new state).

With ``FLAGS_health`` an entry carries the health probe
(``monitor.health``): the step keeps the probed gradients to its end and
computes the per-layer stats inside the captured graph; the probe is
part of the entry's key.  ``FLAGS_check_nan_inf`` checks every floating
fetch and written-back variable after the step and raises naming the
first non-finite one and the step (with the probe on, also the first
op that made one, replayed op by op); ``FLAGS_benchmark`` prints each
step's time after a ``torch.cuda.synchronize``.
"""

import base64
import threading
import time
import weakref

import numpy as np
import torch

from . import compile_cache, fault, flags, guardian, monitor, profiler
from . import registry
from .framework import Variable, default_main_program
from .monitor import health, program_profile
from .ops import control_flow
from .ops.selected_rows import SelectedRows
from .registry import ComputeContext
from .scope import global_scope

__all__ = ["Executor", "CPUPlace", "CUDAPlace", "segment_plan"]


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


def _interpret(block, indices, release, env, ctx, where=None):
    """Compute the ops ``indices`` in order, dropping each temporary after
    its last reader; ``where[0]`` names the op being computed."""
    for i in indices:
        op = block.ops[i]
        if where is not None:
            where[0] = "op %d (%s)" % (i, op.type)
        registry.compute_op(op, env, ctx, op_index=i)
        for n in release[i]:
            env.pop(n, None)


def _host_loops_in(program, block, path):
    """Where each op of ``block`` and its sub-blocks that loops on the host
    sits; ``path`` names the op that owns ``block``."""
    found = []
    for j, op in enumerate(block.ops):
        where = "op %d (%s) of block %d, inside %s" % (j, op.type, block.idx,
                                                       path)
        if registry.splits_capture(op):
            found.append(where)
        if "sub_block" in op.attrs:
            found += _host_loops_in(
                program, program.block(op.attrs["sub_block"]), where)
    return found


def segment_plan(block, live, capture=False):
    """The segments an entry runs in: ``("ops", [op indices])`` for a run
    of live ops, ``("loop", i)`` for live op i that loops on the host
    (``registry.splits_capture``).  With ``capture``, a live op whose
    sub-blocks hold such a loop raises, naming both: a CUDA graph cannot
    hold a host loop, and it is not split out of its op."""
    plan, run = [], []
    for i, op in enumerate(block.ops):
        if not live[i]:
            continue
        if capture and "sub_block" in op.attrs:
            nested = _host_loops_in(
                block.program, block.program.block(op.attrs["sub_block"]),
                "op %d (%s) of block %d" % (i, op.type, block.idx))
            if nested:
                raise RuntimeError(
                    "cannot capture an unbounded while inside a sub-block "
                    "(%s): it reads its condition on the host every trip. "
                    "Give it max_trip_count, or run with "
                    "Executor(capture=False)" % nested[0])
        if registry.splits_capture(op):
            if run:
                plan.append(("ops", run))
                run = []
            plan.append(("loop", i))
        else:
            run.append(i)
    if run:
        plan.append(("ops", run))
    return plan


class _HostLoop:
    """A loop of a captured entry: its body graph over static carry
    buffers, the pinned flag the graph writes the condition into, and the
    event a replay is waited on by."""

    def __init__(self, block, index):
        self.op = block.ops[index]
        self.index = index
        self.cond = control_flow.cond_index(self.op.attrs)
        self.graph = None
        self.ins = self.bufs = None
        with torch.inference_mode(False):
            self.flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
        self.done = torch.cuda.Event()

    def enter(self, env, ctx, release):
        """Captured at the end of the graph before the loop: the carry
        buffers take the loop's initial values, and the body's seeds are
        drawn."""
        self.ins = registry.read_inputs(self.op, env, ctx)
        ctx.seed32(self.index)
        self.bufs = [v.clone() for v in self.ins.pop("LoopVars")]
        registry.write_outputs(self.op, env, {"Out": self.bufs})
        for n in release[self.index]:
            env.pop(n, None)

    def trip(self, ctx):
        """Captured as the body graph: one predicated trip over the
        buffers, written back, and the condition copied to the flag."""
        new = control_flow.while_trip(self.ins, self.op.attrs, ctx,
                                      self.index, self.bufs)
        for b, v in zip(self.bufs, new):
            b.copy_(v)
        self.flag.copy_(self.bufs[self.cond].all(), non_blocking=True)

    def run(self, exe):
        """Replay the body until the flag reads false."""
        trips = 0
        while True:
            self.graph.replay()
            trips += 1
            self.done.record()
            self.done.synchronize()
            exe.flag_reads += 1
            if not bool(self.flag):
                break
        exe.loop_trips.append((self.index, trips))


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
    """An entry's CUDA graphs and the tensors they were captured on."""

    def __init__(self, out_meta):
        # (shape, dtype) of each persistable output, from the eager run
        self.out_meta = out_meta
        # [(graph, the _HostLoop it is the body of, or None)] in order
        self.pieces = None
        self.feeds = {}      # feed name -> _StaticFeed
        self.bound = {}      # scope name -> the tensor the graph uses
        self.reads = set()   # the bound names the graph reads
        self.fetches = []    # the fetched tensors the graph writes

    @property
    def graph(self):
        """The entry's first graph; None before the capture."""
        return self.pieces[0][0] if self.pieces else None

    @property
    def graphs(self):
        """How many CUDA graphs the entry holds."""
        return len(self.pieces or ())

    def replay(self, exe):
        for graph, loop in self.pieces:
            if loop is None:
                graph.replay()
            else:
                loop.run(exe)

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
        self._run_counter = 0
        self._analysis = {}
        self._steps = {}
        self._dead = []      # (key, analysis) of entries whose owner died
        self._host_entries = set()   # keys of entries that call the host
        # key -> (the fetch list the step keeps, the health probe or None)
        self._probes = {}
        # key -> the skip guard's (state names it restores, watched
        # fetches), for guarded entries
        self._guards = {}
        self._generators = {}
        self._lock = threading.RLock()
        self._stream = None
        self._pool = None
        self.loop_trips = []   # (op index, trips) of each loop, last run
        self.flag_reads = 0    # host reads of a loop's condition
        # the watchdog's stall dump lists the live executors' state
        monitor.track(self)

    def monitor_state(self):
        return {"kind": "executor", "device": str(self.place.device),
                "entries": len(self._analysis),
                "graphs": sum(st.graphs for st in self._steps.values()),
                "runs": self._run_counter}

    def state_dict(self):
        """What an exact resume carries (``parallel.checkpoint``): the run
        counter (the fault and guardian step index) and each generator's
        state, JSON-safe.  Exactness needs a nonzero ``random_seed``, as
        in the JAX package: seed 0 draws its seed from numpy."""
        return {"run_counter": int(self._run_counter),
                "generators": {
                    str(seed): base64.b64encode(
                        g.get_state().numpy().tobytes()).decode("ascii")
                    for seed, g in self._generators.items()}}

    def load_state_dict(self, state):
        """Restore ``state_dict()``; a JAX executor's state (its run
        counter alone) sets the counter."""
        with self._lock:
            self._run_counter = int(state["run_counter"])
            for seed, b64 in state.get("generators", {}).items():
                raw = bytearray(base64.b64decode(b64))
                self._generator(int(seed)).set_state(
                    torch.frombuffer(raw, dtype=torch.uint8))

    def sync(self):
        """Wait for the steps launched on the card."""
        if self.place.device.type == "cuda":
            torch.cuda.synchronize(self.place.device)

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
        # the forward ops whose generic grad op (registry keep_graph) or
        # while_grad runs
        graph_ops = frozenset(
            op.attrs["__fwd_op_index__"] for i, op in enumerate(block.ops)
            if live[i] and "__fwd_op_index__" in op.attrs
            and ("__fwd_type__" in op.attrs or op.type == "while_grad"))
        return state, writeback, live, release, graph_ops

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Execute ``program``: ``feed`` maps names to arrays or tensors,
        ``fetch_list`` holds Variables or names; persistable results are
        written back to ``scope``.  Fetches come back as numpy arrays, or
        as tensors on the device with ``return_numpy=False``."""
        # one module-global bool read each when telemetry is off
        mon = monitor._enabled
        obs = mon or profiler._active[0]
        t_mon = time.perf_counter() if mon else None
        t_bench = time.perf_counter() if flags.flag("benchmark") else None
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        block = program.global_block()
        feed = {n: _as_tensor(v) for n, v in (feed or {}).items()}
        feed_names = sorted(feed)
        step_idx = self._run_counter
        if fault._ACTIVE:
            # drills replace feeds (poison_batch), keeping shape and dtype
            vals = [feed[n] for n in feed_names]
            fault.fire("executor/feed", step_idx, feed_names=feed_names,
                       feed_vals=vals)
            feed = {n: _as_tensor(v) for n, v in zip(feed_names, vals)}
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
        # compare by their lists); so do the health probe and the skip
        # guard, which the step computes, and the tuner's kernel rulings
        # (compile_cache.trace_flag_values)
        identity = compile_cache.trace_flag_values(program)
        guarded, probe_on = identity[1], identity[2]
        feed_sig = tuple((n, tuple(feed[n].shape), feed_dtypes[n])
                         for n in feed_names)
        key = (id(program), program._version, feed_sig, tuple(fetch_names),
               program._amp_policy, probe_on, guarded, identity[3],
               id(scope))
        self._run_counter += 1
        fp = program_profile.program_fingerprint(program) if obs else None
        span = profiler.RecordEvent if obs else _NoSpan
        with self._lock:
            self._drop_dead()
            analysis = self._analysis.get(key)
            cold_entry = analysis is None
            if cold_entry:
                if obs:
                    profiler.mark_event("executor/new_entry")
                analysis = self._new_entry(key, program, feed_names, scope,
                                           fetch_names, probe_on, guarded,
                                           feed_sig, identity, span)
            captures = (self.capture and self.place.device.type == "cuda"
                        and key not in self._host_entries)
            phase = self._phase(key, captures, cold_entry)
            profile = None
            # a tuner's probe (program_profile.probe_accounting) reads
            # each entry's warm-up peak
            if phase != "dispatch" and (mon or program_profile._FORCED[0]) \
                    or phase == "warmup" and program_profile._probe_depth[0]:
                profile = ((fp or program_profile.program_fingerprint(
                    program)), tuple((n, tuple(feed[n].shape),
                                      str(feed_dtypes[n]))
                                     for n in feed_names), tuple(fetch_names))
            span_args = {"run_id": monitor.run_id(), "fingerprint": fp[:12],
                         "step": step_idx,
                         "bucket": "compute" if phase == "dispatch"
                         else "trace_compile"} if fp else None
            self.loop_trips = []
            kept, probe = self._probes[key]
            guard = self._guards.get(key)
            # the step's generator state, for an op-by-op replay of it
            gen_state = self._generator(program.random_seed).get_state() \
                if probe is not None else None
            if fault._ACTIVE:
                fault.fire("executor/dispatch", step_idx)
            with span("executor/run"):
                with span("executor/" + phase, args=span_args):
                    if not captures:
                        fetches = self._run_eager(
                            program, analysis, feed, feed_dtypes, scope,
                            kept, profile=profile, span=span, probe=probe,
                            guard=guard)
                    else:
                        with torch.cuda.device(self.place.device):
                            fetches = self._run_captured(
                                key, program, analysis, feed, feed_dtypes,
                                scope, kept, profile=profile, span=span,
                                probe=probe, guard=guard)
                            if not return_numpy:
                                # a later replay rewrites the graph's
                                # outputs
                                fetches = [_clone(f) for f in fetches]
            ok_flag = None
            if guard is not None:
                # the guard's verdict rides last, after the probe's stats
                ok_flag, fetches = fetches[-1], fetches[:-1]
            if probe is not None:
                health.note_step(
                    "executor", step_idx, probe, fetches[-1],
                    program=program, scope=scope,
                    generator_state=gen_state,
                    feed_names=feed_names,
                    feed_vals=[feed[n] for n in feed_names],
                    place=self.place)
            fetches = fetches[:len(fetch_names)]
            if fault._ACTIVE:
                fault.fire("executor/step_done", step_idx, scope=scope,
                           state_names=analysis[1], fetch_names=fetch_names,
                           fetches=fetches)
            if flags.flag("check_nan_inf"):
                _check_finite(
                    list(zip(fetch_names, fetches))
                    + [(n, scope.find_var(n)) for n in analysis[1]],
                    step_idx, probe)
            if t_bench is not None:
                if self.place.device.type == "cuda":
                    torch.cuda.synchronize(self.place.device)
                print("[benchmark] step %.3f ms"
                      % ((time.perf_counter() - t_bench) * 1e3))
            if return_numpy:
                with span("executor/fetch_sync"):
                    fetches = [_to_numpy(f) for f in fetches]
        if t_mon is not None:
            step_s = time.perf_counter() - t_mon
            # a program's _step_hook(step_seconds, warm), before the
            # step's record: a ParallelExecutor plan's pipeline bubble
            # span lands in the step it was measured in
            hook = getattr(program, "_step_hook", None)
            if hook is not None:
                hook(step_s, phase == "dispatch")
            monitor.record_step(
                "executor", step_s,
                _batch_examples(block, feed_names, feed), 0,
                device=self.place.device, warm=phase == "dispatch",
                fingerprint=fp,
                extras=_sparse_step_extras(program, feed_names, feed))
        # the guardian last, after the telemetry: a ladder decision raises
        # out of run() with this step's record published
        g = guardian._ACTIVE
        if g is not None:
            g.note_step("executor", step_idx, ok=ok_flag,
                        fetch_names=fetch_names, fetches=fetches,
                        feed=(feed_names, [feed[n] for n in feed_names]),
                        sync=return_numpy)
        elif ok_flag is not None:
            guardian.warn_unobserved_skip_guard(self)
        return fetches

    def _new_entry(self, key, program, feed_names, scope, fetch_names,
                   probe_on, guarded, feed_sig, identity, span):
        """Analyze a new entry: (state, writeback, live, release,
        graph_ops, plan); its kept fetch list and health probe go to
        ``_probes``, its skip guard (the state it writes that it read, and
        the fetches it watches) to ``_guards``.  The analysis comes from
        ``compile_cache`` when another executor made it for the same
        program, signature and identity (``executor/analyze`` skipped)."""
        captures = self.capture and self.place.device.type == "cuda"
        ckey = compile_cache.trace_key(
            program, feed_sig, (), fetch_names, captures, identity,
            tuple(scope.has_var(n) for n in fetch_names))
        cached = compile_cache.lookup(ckey)
        if cached is not None and not all(scope.has_var(n)
                                           for n in cached[0][0]):
            cached = None    # the scope lacks a state var: _analyze says
        if cached is None:
            with span("executor/analyze"):
                cached = self._analyze_entry(program, feed_names, scope,
                                             fetch_names, probe_on, captures)
            compile_cache.store(ckey, cached)
        analysis, kept, calls_host = cached
        probe = health.build_probe(program, analysis[0]) if probe_on \
            else None
        if calls_host:
            self._host_entries.add(key)
        # an entry's own tuple: a dead entry's report names it by identity
        analysis = self._analysis[key] = tuple(list(analysis))
        guard = None
        if guarded:
            state = set(analysis[0])
            guard = ([n for n in analysis[1] if n in state],
                     list(fetch_names))
        self._probes[key] = (list(kept), probe)
        if guard is not None:
            self._guards[key] = guard
        # reported when either owner dies, which is before another
        # program or scope can take its id
        for owner in (program, scope):
            weakref.finalize(owner, _entry_died, weakref.ref(self),
                             key, analysis).atexit = False
        return analysis

    def _analyze_entry(self, program, feed_names, scope, fetch_names,
                       probe_on, captures):
        """(analysis with its segment plan, the kept fetch list, whether
        a live op calls the host): what ``_new_entry`` caches."""
        block = program.global_block()
        analysis = self._analyze(program, feed_names, scope, fetch_names)
        kept = list(fetch_names)
        if probe_on:
            probe = health.build_probe(program, analysis[0])
            if probe is not None:
                # the probe reads the gradients at the end of the step
                kept += [g for g in probe.grad_names if g not in kept]
                analysis = self._analyze(program, feed_names, scope, kept)
        calls_host = any(live and registry.calls_host(op) for op, live in
                         zip(block.ops, analysis[2]))
        plan = segment_plan(block, analysis[2],
                            capture=captures and not calls_host)
        return analysis + (plan,), tuple(kept), calls_host

    def _phase(self, key, captures, cold_entry):
        """The step span of this run: ``warmup`` (an entry's first, eager
        run), ``capture`` or ``dispatch``."""
        if not captures:
            return "warmup" if cold_entry else "dispatch"
        step = self._steps.get(key)
        if step is None:
            return "warmup"
        return "capture" if step.pieces is None else "dispatch"

    def _drop_dead(self):
        """Drop the entries whose program or scope died."""
        synced = False
        while self._dead:
            key, analysis = self._dead.pop()
            if self._analysis.get(key) is not analysis:
                continue
            del self._analysis[key]
            self._probes.pop(key, None)
            self._guards.pop(key, None)
            self._host_entries.discard(key)
            step = self._steps.pop(key, None)
            if step is not None and step.pieces and not synced:
                # a replay of the graph may still be running
                torch.cuda.synchronize(self.place.device)
                synced = True

    def _run_eager(self, program, analysis, feed, feed_dtypes, scope,
                   fetch_names, out_meta=None, profile=None, span=None,
                   probe=None, guard=None):
        """Run the entry's segments eagerly (``segment_plan``);
        ``out_meta`` collects the persistable outputs' (shape, dtype);
        ``profile`` (fingerprint, feed signature, fetch names) records the
        run as the entry's warm-up in its program profile.  With the
        health probe the stats tensor follows the fetches, and with the
        skip guard its verdict follows them."""
        state_names, writeback, live, release, graph_ops, plan = analysis
        dev = self.place.device
        block = program.global_block()
        cuda = dev.type == "cuda"
        if profile is not None and cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        generator = self._generator(program.random_seed)
        with (span or _NoSpan)("executor/h2d_transfer"):
            env = {n: feed[n].to(device=dev, dtype=feed_dtypes[n])
                   for n in feed}
        env.update((n, _scope_tensor(scope, n, dev)) for n in state_names)
        ctx = ComputeContext(dev, generator, len(block.ops),
                             program._amp_policy, program, graph_ops)
        old = health.begin_step(probe, env, writeback) \
            if probe is not None else None
        before = _guard_begin(env, guard)
        for kind, seg in plan:
            if kind == "ops":
                _interpret(block, seg, release, env, ctx)
            else:
                self._loop_eager(block, seg, release, env, ctx)
        ok = _guard_end(env, guard, before, dev)
        stats = health.probe_stats(probe, env, old) \
            if probe is not None else None
        for n in writeback:
            scope.set_var(n, env[n])
            if out_meta is not None:
                out_meta[n] = (tuple(env[n].shape), env[n].dtype)
        if profile is not None:
            program_profile.note_warmup(
                profile[0], profile[1], dev,
                torch.cuda.max_memory_allocated(dev) if cuda else None,
                fetch_names=profile[2])
        return [env[n] for n in fetch_names] + \
            ([stats] if stats is not None else []) + \
            ([ok] if ok is not None else [])

    def _loop_eager(self, block, i, release, env, ctx):
        """Run loop op ``i``: predicated trips, the condition read on the
        host after each, as a captured entry replays its body graph."""
        op = block.ops[i]
        ins = registry.read_inputs(op, env, ctx)
        ctx.seed32(i)
        carry, trips = control_flow.host_loop(ins, op.attrs, ctx, i,
                                              ins.pop("LoopVars"))
        self.flag_reads += trips
        self.loop_trips.append((i, trips))
        registry.write_outputs(op, env, {"Out": carry})
        for n in release[i]:
            env.pop(n, None)

    def _run_captured(self, key, program, analysis, feed, feed_dtypes,
                      scope, fetch_names, profile=None, span=None,
                      probe=None, guard=None):
        span = span or _NoSpan
        step = self._steps.get(key)
        if step is not None and step.pieces is not None \
                and not step.bind(scope):
            step = None   # the state changed shape or dtype: cold again
        if step is None:
            out_meta = {}
            fetches = self._run_eager(program, analysis, feed, feed_dtypes,
                                      scope, fetch_names, out_meta,
                                      profile=profile, span=span,
                                      probe=probe, guard=guard)
            self._steps[key] = _CapturedStep(out_meta)
            return fetches
        first = step.pieces is None
        if first:
            dev = self.place.device
            # the warm-up's freed blocks stay cached for the eager path; a
            # capture allocates its own pool, so where the cached blocks
            # outweigh the card's free memory they go back first
            free = torch.cuda.mem_get_info(dev)[0]
            if torch.cuda.memory_reserved(dev) \
                    - torch.cuda.memory_allocated(dev) > free:
                torch.cuda.empty_cache()
            if profile is not None:
                program_profile.preflight(
                    profile[0], profile[1], dev,
                    torch.cuda.memory_allocated(dev),
                    fetch_names=profile[2])
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
            self._capture(step, program, analysis, feed, feed_dtypes, scope,
                          fetch_names, probe, guard)
            if profile is not None:
                program_profile.note_capture(
                    profile[0], profile[1], time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated(dev), step.graphs,
                    fetch_names=profile[2])
            if monitor._enabled:
                monitor.note_graph("captures", step.graphs)
        with span("executor/h2d_transfer"):
            for n, f in step.feeds.items():
                f.load(feed[n])
        if first and profile is not None:
            _profiled_replay(step, self, profile)
        else:
            step.replay(self)
        if monitor._enabled:
            monitor.note_graph("replays")
        return step.fetches

    def _capture(self, step, program, analysis, feed, feed_dtypes, scope,
                 fetch_names, probe=None, guard=None):
        """Capture the entry's segments into ``step.pieces`` on the feeds'
        and the scope's current tensors: a graph for each run of ops (the
        one before a loop ending with the loop's entry), a body graph for
        each loop, and the write-back in the last graph.  The caller
        replays them."""
        state_names, writeback, live, release, graph_ops, plan = analysis
        dev = self.place.device
        block = program.global_block()
        for n in feed:
            step.feeds[n] = _StaticFeed(feed[n].shape, feed_dtypes[n], dev)
        if probe is not None:
            # the stats buffer outlives the graph's pool: a replay writes
            # it, the host reads it on the probe's cadence
            with torch.inference_mode(False):
                probe.buffer = torch.empty((len(probe.labels), 4),
                                           dtype=torch.float32, device=dev)
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
        env = {n: f.buffer for n, f in step.feeds.items()}
        env.update((n, step.bound[n]) for n in state_names)
        ctx = ComputeContext(dev, generator, len(block.ops),
                             program._amp_policy, program, graph_ops)
        where = ["the start of the step"]
        old, before, verdict = {}, {}, []

        def capture(work):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(generator)
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                work()
            return graph

        def write_back():
            if guard is not None:
                where[0] = "the skip guard"
                verdict.append(_guard_end(env, guard, before, dev))
            if probe is not None:
                where[0] = "the health probe's stats"
                health.probe_stats(probe, env, old)
            where[0] = "the write-back of the persistable outputs"
            for n in writeback:
                if env[n] is not step.bound[n]:
                    step.bound[n].copy_(env[n])

        pieces, k = [], 0
        try:
            while True:
                ops = plan[k][1] if k < len(plan) and plan[k][0] == "ops" \
                    else []
                k += bool(ops)
                loop = _HostLoop(block, plan[k][1]) if k < len(plan) \
                    else None

                first = not pieces

                def head():
                    if first and guard is not None:
                        where[0] = "the skip guard's state copies"
                        before.update(_guard_begin(env, guard))
                    if first and probe is not None:
                        where[0] = "the health probe's parameter copies"
                        old.update(health.begin_step(probe, env, writeback))
                    _interpret(block, ops, release, env, ctx, where)
                    if loop is not None:
                        where[0] = "the entry of loop op %d" % loop.index
                        loop.enter(env, ctx, release)
                    else:
                        write_back()

                if ops or loop is not None or guard is not None or any(
                        env[n] is not step.bound[n] for n in writeback):
                    pieces.append((capture(head), None))
                if loop is None:
                    break
                where[0] = "the body of loop op %d (while)" % loop.index
                loop.graph = capture(lambda: loop.trip(ctx))
                pieces.append((loop.graph, loop))
                k += 1
            step.fetches = [env[n] for n in fetch_names] + \
                ([probe.buffer] if probe is not None else []) + verdict
        except Exception as e:
            raise RuntimeError(
                "CUDA graph capture of program %d (version %d) failed at "
                "%s: %s" % (id(program), program._version, where[0], e)) \
                from e
        step.pieces = pieces


class _NoSpan:
    """The span of a run with the monitor and the profiler off."""

    def __init__(self, name, args=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _guard_begin(env, guard):
    """The skip guard's device copies of the state the step writes, as it
    stands before the step ({} without the guard)."""
    if guard is None:
        return {}
    return {n: env[n].clone() for n in guard[0]}


def _guard_end(env, guard, before, device):
    """The skip guard's verdict (a 0-d bool tensor: every floating watched
    fetch finite) with the state put back where it is false; None
    without the guard.  Device arithmetic only, so a graph holds it."""
    if guard is None:
        return None
    ok = torch.ones((), dtype=torch.bool, device=device)
    for n in guard[1]:
        v = env.get(n)
        if isinstance(v, SelectedRows):
            v = v.values
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            ok = ok & torch.isfinite(v).all()
    for n, old in before.items():
        env[n] = torch.where(ok, env[n], old)
    return ok


def _profiled_replay(step, exe, profile):
    """The entry's first replay, measured for its program profile: its
    device time between two CUDA events, and the kernels (and all device
    events) a ``torch.profiler`` trace of it shows.  Inside another
    profiler session the trace is not taken (launches None).  The trace's
    window opens with ``profiler.open_trace_window``'s pads, left out of
    the counts (``trace_pads_lost`` says how many of them it lost)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    prof = None
    if not torch._C._autograd._profiler_enabled():
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        profiler.open_trace_window()
    start.record()
    step.replay(exe)
    end.record()
    end.synchronize()
    launches = events = pads_lost = None
    if prof is not None:
        prof.__exit__(None, None, None)
        device, pads = profiler.window_device_events(prof)
        pads_lost = profiler.TRACE_PADS - pads
        events = len(device)
        launches = len(profiler.kernel_events(device))
    program_profile.note_replay(profile[0], profile[1],
                                start.elapsed_time(end), launches, events,
                                fetch_names=profile[2], pads_lost=pads_lost)


def _check_finite(named_vals, step, probe):
    """``FLAGS_check_nan_inf``: raise naming the first floating variable
    holding a NaN or an infinity after ``step``, the others found in the
    same scan, and (with the health probe on) the first op that made
    one."""
    bad, first_kind = [], None
    for name, v in named_vals:
        if isinstance(v, SelectedRows):
            v = v.values
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            continue
        if not bool(torch.isfinite(v).all()):
            bad.append(name)
            if first_kind is None:
                first_kind = "nan" if bool(torch.isnan(v).any()) else "inf"
    if not bad:
        return
    others = "" if len(bad) == 1 else " (+%d more non-finite: %s)" % (
        len(bad) - 1, ", ".join(repr(n) for n in bad[1:5]))
    msg = ("check_nan_inf: variable %r contains %s after step %d%s "
           "[run_id=%s]" % (bad[0], first_kind, step, others,
                            monitor.run_id()))
    if probe is not None:
        rec = health.nan_provenance(step)
        if rec is not None and rec.get("found"):
            msg += "; first non-finite op: %s -> %r (op #%d%s)" % (
                rec["op_type"], rec["out_var"], rec["op_index"],
                ", layer %s" % rec["layer"] if rec.get("layer") else "")
    raise RuntimeError(msg)


def _batch_examples(block, feed_names, feed):
    """Examples a step for StepStats: the leading dim of a feed whose
    program var declares a batch dim (shape[0] -1 or None), else the
    largest leading dim of the feeds."""
    best = 0
    for n in feed_names:
        v = feed[n]
        if v.dim() < 1:
            continue
        pv = block._find_var_recursive(n)
        if pv is not None and pv.shape is not None \
                and len(pv.shape) >= 1 and pv.shape[0] in (-1, None):
            return int(v.shape[0])
        best = max(best, int(v.shape[0]))
    return best


def _sparse_feed_info(program):
    """(the feeds that index an ``is_sparse`` table, the tables' bytes),
    cached on the program by version."""
    cached = getattr(program, "_sparse_feed_cache", None)
    if cached is not None and cached[0] == program._version:
        return cached[1]
    from .ops.selected_rows import sparse_lookup_tables

    table_bytes = 0
    for v in sparse_lookup_tables(program).values():
        dtype = v.dtype if isinstance(v.dtype, torch.dtype) \
            else torch.float32
        table_bytes += int(np.prod(v.shape)) * (
            torch.finfo(dtype).bits if dtype.is_floating_point
            else torch.iinfo(dtype).bits) // 8
    feeds = []
    for blk in program.blocks:
        for op in blk.ops:
            if op.type != "lookup_table" or \
                    not op.attrs.get("is_sparse", False):
                continue
            for n in op.inputs.get("Ids", []):
                v = blk._find_var_recursive(n)
                if v is not None and getattr(v, "is_data", False) \
                        and n not in feeds:
                    feeds.append(n)
    hit = (tuple(feeds), table_bytes)
    program._sparse_feed_cache = (program._version, hit)
    return hit


def _sparse_step_extras(program, feed_names, feed):
    """Step-record extras of the sparse embedding path: distinct rows the
    step touched (host feeds only: a card's feed is not read back) and
    the tables' bytes; bumps ``sparse/touched_rows``.  None without an
    ``is_sparse`` table."""
    feeds, table_bytes = _sparse_feed_info(program)
    if not feeds:
        return None
    touched = 0
    for n in feeds:
        v = feed.get(n)
        if v is not None and v.device.type == "cpu" and v.numel():
            touched += int(np.unique(v.numpy()).size)
    monitor.count("sparse/touched_rows", touched)
    return {"sparse_touched_rows": touched,
            "sparse_table_bytes": int(table_bytes)}


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
