"""ParallelExecutor: a program over a mesh of processes (counterpart of
``paddle_tpu/parallel/parallel_executor.py``; the reference's
``framework/parallel_executor.cc:58-247``).

The JAX package traces the program once and jit-compiles it over a named
mesh, GSPMD inserting every collective, one process driving every local
device.  The port runs one process a device, in the world
``distributed.init_distributed`` joins: each rank runs ``plan.
plan_program``'s copy of the program — the collectives placed where the
single-device arithmetic needs them — through the port's ``Executor``
(captured into one CUDA graph an entry on the card), on its share of the
batch and of the state.  The result is what the single-device run
computes: a global-batch mean loss, global-batch batch-norm statistics,
dropout masks of the global positions; only the order of summation
differs.

* Feeds: ``run`` takes the global batch (the same dict on every rank, or
  the reference's per-device list of dicts, concatenated) and each rank
  keeps its rows: dim 0 split over the data axes (``dp`` x ``fsdp``), the
  rank's block by its position along them.  ``run(..., local_feed=True)``
  takes the rank's own rows instead, as the JAX package's multi-host
  processes feed their local slices.  A global batch the data axes do not
  divide is replicated whole ``dp / gcd(B, dp)`` times
  (``BuildStrategy.pad_uneven_batches``; ``uneven_batches_padded`` counts
  them), or refused when that option is off; per-sample fetches are
  trimmed back.
* State: each persistable var gets a ``PartitionSpec`` as in the JAX
  package (``param_sharding_fn`` > ``sharding_rules`` > the reduce
  strategy's ZeRO dim-0 rule); a split var lives in the scope as the
  rank's shard (a full value put there is cut at the next run), gathered
  before use, its gradient reduce-scattered (``plan.py``).  At the first
  run of a program every rank takes rank 0's state, so a startup drawn
  from an unseeded generator still starts every rank alike.
* Fetches come back global on every rank.

``ParallelExecutor(use_cuda=True)`` runs on ``cuda:<local rank>`` over the
world's NCCL and raises where the process sees no card; ``use_cuda=False``
runs on the CPU over gloo (a gloo world, or no world).  Nothing switches
from one to the other.  Without ``init_distributed`` the mesh is one
rank's, and the plan's program is the single-device program: a collective
over an axis of extent 1 is none.

* Sequence parallelism (``sp``): with ``BuildStrategy.sequence_parallel``
  every ``fused_attention`` op lowers to ring attention over ``sp``
  where its shapes allow (``ops/attention.py``); every other op runs
  whole on each ``sp`` rank, as GSPMD keeps the JAX package's ops
  outside its ring replicated over ``sp``.
* Pipeline parallelism (``pp``): each ``pipeline_region`` op whose stage
  count fits the ``pp`` extent runs ``BuildStrategy.pipeline_schedule``
  (gpipe, 1f1b or interleaved) with ``pipeline_microbatches`` microbatches
  over the ``pp`` group; the ops outside the regions run whole on each
  ``pp`` rank.  With the monitor on, a warm step's ``pipeline/bubble``
  span carves the schedule's idle fraction out of the step
  (``pipeline_stats``; the goodput ledger's ``pipeline_bubble`` bucket).
"""

import math
import warnings

import numpy as np
import torch

from .. import compile_cache, monitor
from ..executor import CPUPlace, CUDAPlace, Executor, _as_tensor
from ..framework import Variable, default_main_program
from ..scope import global_scope
from . import distributed
from .collective import MeshRuntime
from .mesh import AXIS_DP, AXIS_FSDP, AXIS_PP, make_mesh
from .mesh import PartitionSpec as P
from .pipeline import normalize_schedule, region_plan, schedule_stats
from .plan import plan_program
from .spec_layout import SpecLayout
from .strategy import BuildStrategy, ExecutionStrategy

__all__ = ["ParallelExecutor", "Sharding"]

_DEFAULT_SPEC_LAYOUT = SpecLayout()


class Sharding:
    """Where a var lives on a mesh: its ``PartitionSpec`` and this rank's
    block of it (the port's ``NamedSharding``).  ``shard(full)`` cuts a
    full value to the rank's block; ``local_shape(shape)``."""

    def __init__(self, mesh, spec, rank):
        self.mesh, self.spec, self.rank = mesh, spec, int(rank)

    def local_shape(self, shape):
        out = list(shape)
        for d in range(len(out)):
            k = self.mesh.extent(self.spec.axes(d))
            if k > 1:
                out[d] //= k
        return tuple(out)

    def shard(self, full):
        return MeshRuntime(self.mesh, self.rank, None).reshard(
            _as_tensor(full), P(), self.spec)

    def __repr__(self):
        return "Sharding(%r, %r)" % (self.mesh, self.spec)


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, mesh=None):
        self._mesh = mesh if mesh is not None else make_mesh()
        names = self._mesh.axis_names
        if AXIS_DP not in names and AXIS_FSDP not in names:
            raise ValueError("mesh must have a data axis (%r or %r)"
                             % (AXIS_DP, AXIS_FSDP))
        world = distributed.process_count()
        if self._mesh.size != world:
            raise ValueError(
                "mesh %r holds %d ranks but the world has %d processes"
                % (self._mesh, self._mesh.size, world))
        self._rank = distributed.process_id()
        if use_cuda:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ParallelExecutor(use_cuda=True) runs on a CUDA card "
                    "and this process sees none; use_cuda=False runs on "
                    "the CPU")
            place = CUDAPlace(distributed.local_rank())
        else:
            place = CPUPlace()
        wdev = distributed.device()
        if wdev is not None and wdev.type != place.device.type:
            raise ValueError(
                "ParallelExecutor(use_cuda=%s) in a world joined on %s: "
                "the executor's device and the world's collectives must "
                "be on the same side" % (bool(use_cuda), wdev))
        self.place = place
        self._exe = Executor(place)
        self._runtime = MeshRuntime(self._mesh, self._rank, place.device)
        self._program = main_program
        self._scope = scope
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._loss_name = loss_name
        self._num_trainers = num_trainers
        self._trainer_id = trainer_id
        self._plans = {}
        self._synced = set()     # (program id, scope id) state synced
        self._seeded = False
        self.uneven_batches_padded = 0
        if share_vars_from is not None:
            self._scope = share_vars_from._actual_scope()

    # ------------------------------------------------------------------
    @property
    def device_count(self):
        return self._mesh.size

    @property
    def mesh(self):
        return self._mesh

    def _actual_scope(self):
        return self._scope if self._scope is not None else global_scope()

    def _data_axes(self):
        """The mesh's data axes in (dp, fsdp) order."""
        return tuple(a for a in (AXIS_DP, AXIS_FSDP)
                     if a in self._mesh.axis_names)

    def _dp_size(self):
        return self._mesh.extent(self._data_axes())

    def _zero_axis(self):
        """``fsdp`` when the mesh has a populated one, else ``dp`` (the
        kReduce ZeRO axis)."""
        if self._mesh.axis_size(AXIS_FSDP) > 1 or \
                AXIS_DP not in self._mesh.axis_names:
            return AXIS_FSDP
        return AXIS_DP

    def _spec_fits(self, spec, shape):
        entries = tuple(spec)
        if len(entries) > len(shape):
            return False
        for d, dim in enumerate(shape):
            axes = spec.axes(d)
            if any(a not in self._mesh.axis_names for a in axes):
                return False
            total = self._mesh.extent(axes)
            if total > 1 and (dim <= 0 or dim % total != 0):
                return False
        return True

    def feed_sharding(self):
        """The ``Sharding`` of a batch feed: dim 0 over the data axes (the
        ``shardings=`` of ``DevicePrefetcher`` / ``DataFeeder.prefetch``,
        whose batches ``run(..., local_feed=True)`` then takes)."""
        axes = tuple(a for a in self._data_axes()
                     if self._mesh.axis_size(a) > 1)
        spec = P(axes if len(axes) > 1 else axes[0]) if axes else P()
        return Sharding(self._mesh, spec, self._rank)

    def _sharding_layout(self):
        rules = self._build_strategy.sharding_rules
        return _DEFAULT_SPEC_LAYOUT if rules is True else rules

    def _state_spec(self, name, shape, rule_specs):
        """The spec of a persistable var: the ``param_sharding_fn`` hook
        (when it gives one), the resolved ``sharding_rules``, then the
        reduce strategy (ZeRO dim 0 over the zero axis under kReduce,
        replicated under kAllReduce), as in the JAX package."""
        custom = self._build_strategy.param_sharding_fn
        if custom is not None:
            spec = custom(name, tuple(shape))
            if spec is not None:
                spec = P(*spec)
                if not self._spec_fits(spec, tuple(shape)):
                    raise ValueError(
                        "param_sharding_fn spec %r does not divide %r of "
                        "shape %s on mesh %s" % (spec, name, tuple(shape),
                                                 self._mesh))
                return spec
        rule = rule_specs.get(name)
        if rule is not None and rule != P():
            return rule
        if self._build_strategy.reduce_strategy == \
                BuildStrategy.ReduceStrategy.Reduce:
            ax = self._zero_axis()
            if len(shape) >= 1 and shape[0] > 0 \
                    and shape[0] % self._mesh.axis_size(ax) == 0:
                return P(ax)
        return P()

    def _global_shape(self, program, name, value):
        v = program.global_block()._find_var_recursive(name)
        shape = None if v is None else v.shape
        if shape is None or any(s is None or s < 0 for s in shape):
            shape = tuple(np.shape(value))
        return tuple(int(s) for s in shape)

    def _state(self, program, scope):
        """{name: global shape} of the persistable vars the program reads
        or writes that the scope holds."""
        block = program.global_block()
        out = {}
        for op in block.ops:
            for n in op.input_arg_names + op.output_arg_names:
                if not n or n in out:
                    continue
                v = block._find_var_recursive(n)
                if v is not None and v.persistable and scope.has_var(n):
                    out[n] = self._global_shape(program, n, scope.var(n))
        return out

    def _specs(self, program, shapes):
        layout = self._sharding_layout()
        rule_specs = {}
        if layout is not None:
            rule_specs = layout.resolve(program, self._mesh,
                                        list(shapes.items()))
        return {n: self._state_spec(n, s, rule_specs)
                for n, s in shapes.items()}

    def state_shardings(self, program=None, scope=None):
        """{name: Sharding} of every persistable var of ``program`` as this
        executor places it: the ``shardings=`` of ``apply_train_state``,
        which then puts each rank's shard in the scope directly."""
        program = program if program is not None else (
            self._program or default_main_program())
        scope = scope if scope is not None else self._actual_scope()
        shapes = {}
        for var in program.global_block().vars.values():
            if var.persistable and scope.has_var(var.name):
                shapes[var.name] = self._global_shape(
                    program, var.name, scope.var(var.name))
        return {n: Sharding(self._mesh, s, self._rank)
                for n, s in self._specs(program, shapes).items()}

    # ------------------------------------------------------------------
    def _plan(self, program, scope, feed_names, batch_feeds, fetch_names):
        bs = self._build_strategy
        knobs = (bool(bs.sequence_parallel),
                 normalize_schedule(bs.pipeline_schedule),
                 int(bs.pipeline_microbatches or 0))
        key = (id(program), program._version, tuple(feed_names),
               tuple(batch_feeds), tuple(fetch_names), id(scope),
               bs.reduce_strategy, bs.param_sharding_fn,
               bs.feed_sharding_fn, self._sharding_layout(), knobs)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        shapes = self._state(program, scope)
        specs = self._specs(program, shapes)
        # the identity every rank's plan shares: the program, the mesh and
        # the strategy knobs (the JAX package's trace key)
        ckey = compile_cache.trace_key(
            program, tuple(feed_names), tuple(sorted(shapes.items())),
            fetch_names, "mesh_plan",
            (self._mesh.axis_names, self._mesh.shape, self._mesh.ranks),
            self._rank, tuple(batch_feeds), bs.reduce_strategy,
            bs.param_sharding_fn, bs.feed_sharding_fn,
            self._sharding_layout(), knobs)
        plan = compile_cache.lookup(ckey)
        if plan is None or plan.program._mesh_runtime is not self._runtime:
            plan = plan_program(program, self._mesh, self._rank, specs,
                                list(batch_feeds), list(fetch_names),
                                self._data_axes(), self._runtime,
                                sequence_parallel=knobs[0],
                                pipeline_schedule=bs.pipeline_schedule,
                                pipeline_microbatches=knobs[2] or None)
            compile_cache.store(ckey, plan)
        plan.shapes = shapes
        plan.pipeline_stats = stats = self._pipeline_stats(program)
        plan.program._step_hook = None if stats is None \
            else self._note_bubble(stats)
        self._plans[key] = plan
        if self._mesh.size > 1:
            self._runtime.prepare([tuple(a) for a in plan.axes_used])
        return plan

    def _pipeline_stats(self, program):
        """The per-tick stage-idle accounting of the program's
        ``pipeline_region`` ops under this executor's mesh and schedule
        (``pipeline.schedule_stats``), as the JAX package's: the numbers
        behind the goodput ledger's ``pipeline_bubble`` bucket, by the
        op's own ``region_plan``; None when no region runs pipelined."""
        pp = self._mesh.axis_size(AXIS_PP)
        if pp <= 1:
            return None
        schedule = normalize_schedule(self._build_strategy.pipeline_schedule)
        override = self._build_strategy.pipeline_microbatches
        regions = []
        for op in program.global_block().ops:
            if op.type != "pipeline_region":
                continue
            v, m = region_plan(op.attrs, schedule, pp, override)
            if v:
                regions.append(schedule_stats(schedule, pp, m, v))
        if not regions:
            return None
        total = sum(r["total_units"] for r in regions)
        idle = sum(r["idle_units"] for r in regions)
        return {"schedule": schedule,
                "bubble_fraction": idle / total if total else 0.0,
                "regions": regions}

    @staticmethod
    def _note_bubble(stats):
        """A pipelined plan's step hook (the executor calls it with the
        monitor on): a warm step's ``pipeline/bubble`` span, the step's
        seconds times the executed schedule's idle fraction (the JAX
        package's attribution)."""
        def hook(step_s, warm):
            if warm:
                monitor.observe_span(
                    "pipeline/bubble", step_s * stats["bubble_fraction"]
                    * 1e6, args={"bucket": "pipeline_bubble",
                                 "schedule": stats["schedule"],
                                 "fraction": round(
                                     stats["bubble_fraction"], 4),
                                 "run_id": monitor.run_id()})
        return hook

    def _sync_state(self, program, scope, plan):
        """At a program's first run in a world, every rank takes rank 0's
        state (in name order, one broadcast a var)."""
        key = (id(program), id(scope))
        if key in self._synced:
            return
        self._synced.add(key)
        if self._mesh.size <= 1:
            return
        import torch.distributed as dist

        dev = self.place.device
        for n in sorted(plan.shapes):
            val = scope.var(n)
            t = _as_tensor(val).to(dev).contiguous()
            if tuple(t.shape) != tuple(plan.shapes[n]):
                continue       # already a shard: placed by this executor
            t = t.clone()
            dist.broadcast(t, src=self._mesh.ranks[0])
            scope.set_var(n, t)

    def _place_state(self, scope, plan):
        """Cut every split var the scope holds whole to the rank's
        shard."""
        for n, spec in plan.specs.items():
            val = scope.find_var(n)
            if val is None or tuple(np.shape(val)) != tuple(plan.shapes[n]):
                continue
            sh = Sharding(self._mesh, spec, self._rank)
            scope.set_var(n, sh.shard(_as_tensor(val).to(
                self.place.device)).clone())

    def _seed(self, program):
        """A program without a random seed draws one: rank 0's, so every
        rank draws the same masks."""
        if self._seeded or program.random_seed or self._mesh.size <= 1:
            return
        import torch.distributed as dist

        self._seeded = True
        t = torch.tensor([np.random.randint(0, 2 ** 31 - 1)],
                         dtype=torch.int64, device=self.place.device)
        dist.broadcast(t, src=self._mesh.ranks[0])
        g = torch.Generator(device=self.place.device)
        g.manual_seed(int(t.item()))
        self._exe._generators[0] = g

    # ------------------------------------------------------------------
    def _pad_uneven(self, feed, dp):
        """Replicate a ragged global batch whole, r = dp / gcd(B, dp)
        times (exact for mean-normalized losses and batch-norm
        statistics)."""
        sizes = {int(v.shape[0]) for v in feed.values() if v.dim() >= 1}
        if len(sizes) != 1:
            return feed, 1
        b = sizes.pop()
        if b <= 0 or b % dp == 0:
            return feed, 1
        if not self._build_strategy.pad_uneven_batches:
            name = next(iter(feed))
            raise ValueError(
                "feed %r batch dim %s is not divisible by the "
                "data-parallel mesh extent %d (dp x fsdp)"
                % (name, (b,), dp))
        r = dp // math.gcd(b, dp)
        if self.uneven_batches_padded == 0:
            warnings.warn(
                "ragged batch %d replicated x%d to fit the dp=%d mesh: "
                "exact for mean-normalized losses and BN stats; a "
                "sum-reduced objective would scale by the replication "
                "factor — set BuildStrategy.pad_uneven_batches=False to "
                "reject ragged batches instead" % (b, r, dp), stacklevel=3)
        self.uneven_batches_padded += 1
        return {n: torch.cat([v] * r, dim=0) if v.dim() >= 1 else v
                for n, v in feed.items()}, r

    def _feed_split(self, feed, local_feed):
        """(the rank's feed, the names split along dim 0, the replication
        factor of a padded ragged batch)."""
        custom = self._build_strategy.feed_sharding_fn
        batch = []
        for n, v in feed.items():
            spec = custom(n, tuple(v.shape)) if custom is not None else None
            if spec is not None and P(*spec) == P():
                continue
            if spec is not None and P(*spec).axes(0) and \
                    set(P(*spec).axes(0)) <= set(self._data_axes()) and \
                    all(not P(*spec).axes(d) for d in range(1, len(spec))):
                batch.append(n)
                continue
            if spec is not None:
                raise NotImplementedError(
                    "feed_sharding_fn spec %r for feed %r: the mesh runtime "
                    "splits a feed along dim 0 over the data axes or not at "
                    "all" % (spec, n))
            if v.dim() >= 1:
                batch.append(n)
        dp = self._dp_size()
        if local_feed or dp <= 1:
            return feed, batch, 1
        padded, r = self._pad_uneven({n: feed[n] for n in batch}, dp)
        i = self._runtime.index(self._data_axes())
        out = dict(feed)
        for n in batch:
            v = padded[n]
            b = int(v.shape[0])
            if b % dp:
                raise ValueError(
                    "feed %r batch dim %s is not divisible by the "
                    "data-parallel mesh extent %d (dp x fsdp)"
                    % (n, (b,), dp))
            out[n] = v[i * (b // dp):(i + 1) * (b // dp)]
        return out, batch, r

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True,
            local_feed=False):
        program = self._program or default_main_program()
        scope = self._actual_scope()
        feed = feed if feed is not None else feed_dict
        if isinstance(feed, (list, tuple)):
            # the reference's per-device feed list: one global batch
            feed = {k: np.concatenate([np.asarray(d[k]) for d in feed],
                                      axis=0) for k in feed[0]}
        feed = {n: _as_tensor(v) for n, v in (feed or {}).items()}
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        local, batch_feeds, pad_r = self._feed_split(feed, local_feed)
        plan = self._plan(program, scope, sorted(local), sorted(batch_feeds),
                          fetch_names)
        self._sync_state(program, scope, plan)
        self._place_state(scope, plan)
        self._seed(program)
        fetches = self._exe.run(plan.program, feed=local,
                                fetch_list=plan.fetch_names, scope=scope,
                                return_numpy=return_numpy)
        if monitor._enabled:
            # this rank's device gauges (a rank drives one device)
            monitor.sample_device_gauges([self.place.device])
        if pad_r > 1:
            fetches = [f[:f.shape[0] // pad_r]
                       if n in plan.batch_fetches else f
                       for n, f in zip(fetch_names, fetches)]
        return list(fetches)

    def sync(self):
        """Wait for the steps launched on the card."""
        self._exe.sync()

    def state_dict(self):
        """What an exact resume carries: the inner executor's run counter
        and generator states."""
        return self._exe.state_dict()

    def load_state_dict(self, state):
        self._exe.load_state_dict(state)

    def gathered_state(self, state, program=None):
        """``state`` ({name: scope value}) with every var this executor
        holds split gathered whole (a collective: every rank calls it;
        ``parallel.checkpoint.capture_train_state``)."""
        program = program if program is not None else (
            self._program or default_main_program())
        out = dict(state)
        specs, shapes = self._held_specs(state, program)
        for n in sorted(out):
            t = _as_tensor(out[n]).to(self.place.device)
            if tuple(t.shape) == shapes[n]:
                continue
            out[n] = self._runtime.reshard(t, specs[n], P())
        return out

    def _held_specs(self, state, program):
        """({name: spec}, {name: global shape}) of ``state``: each var's
        spec in this executor's plans, else where it would place the var
        (a state restored with ``state_shardings()`` before any run)."""
        specs = {}
        for plan in self._plans.values():
            specs.update(plan.specs)
        shapes = {n: self._global_shape(program, n, v)
                  for n, v in state.items()}
        if any(n not in specs for n in state):
            specs = dict(self._specs(program, shapes), **specs)
        return specs, shapes

    def owned_shards(self, state, program=None):
        """(entries, global shapes) of ``state`` ({name: scope value}) that
        this rank writes in a sharded checkpoint
        (``parallel.checkpoint.capture_train_state(sharded=True)``), with
        no collective: a var held whole is owned by the rank at
        coordinate 0 on every axis; a split var's block by the rank at
        coordinate 0 on every axis its spec does not use (under
        ``P("fsdp")`` on a (dp 2, fsdp 2) mesh, the two dp-0 ranks own the
        halves).  Each entry is ``{"name", "index", "data"}``: the global
        ``[[start, stop], ...]`` of the block and a host copy of it."""
        program = program if program is not None else (
            self._program or default_main_program())
        specs, shapes = self._held_specs(state, program)
        coords = self._mesh.coords(self._rank)
        entries = []
        for n in sorted(state):
            full, local = shapes[n], tuple(np.shape(state[n]))
            spec = specs[n] if local != full else P()
            if Sharding(self._mesh, spec, self._rank).local_shape(full) \
                    != local:
                raise ValueError(
                    "var %r is held at shape %s: neither its global shape "
                    "%s nor its block under %r on %r"
                    % (n, local, full, spec, self._mesh))
            used = {a for d in range(len(full)) for a in spec.axes(d)}
            if any(coords[a] for a in self._mesh.axis_names
                   if a not in used):
                continue          # a replica of a block another rank owns
            index = []
            for d, dim in enumerate(full):
                axes = spec.axes(d)
                size = dim // self._mesh.extent(axes)
                i = self._mesh.index(self._rank, axes)
                index.append([i * size, (i + 1) * size])
            entries.append({"name": n, "index": index,
                            "data": _as_tensor(state[n]).detach().to(
                                "cpu", copy=True)})
        return entries, shapes

    @property
    def executor(self):
        """The ``Executor`` that runs this rank's program."""
        return self._exe
