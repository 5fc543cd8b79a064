"""DistributeTranspiler: the sharding-plan rewriter (counterpart of
``paddle_tpu/transpiler/distribute_transpiler.py``, whose plan logic this
copies).

Parity: reference ``transpiler/distribute_transpiler.py:144,237`` — there
it slices each param/grad into blocks (``slice_variable:79``), rewrites
the trainer program with send/recv ops and generates a pserver program
of optimize sub-blocks.  Here parameters never leave the mesh, so
"transpiling" means deciding *where each tensor lives*:

* large params (numel >= min_block_size, the reference's slicing
  threshold) are sharded over the dp axis (ZeRO-style, the kReduce
  analog of pserver-sharded optimizer state);
* ``is_distributed`` embedding tables row-shard over ep/dp
  (the sharded lookup-table path);
* everything else is replicated.

``transpile()`` returns the plan; ``get_trainer_program()`` returns the
original program (``ParallelExecutor``'s plan places the collectives),
and ``get_pserver_program()`` raises: there is no server role.
"""

import numpy as np

from ..framework import default_main_program
from ..parallel.embedding import distributed_tables
from ..parallel.mesh import AXIS_DP, AXIS_EP
from ..parallel.mesh import PartitionSpec as P
from ..parallel.strategy import BuildStrategy

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "slice_variable"]


def slice_variable(var_list, slice_count, min_block_size=8192):
    """Partition each variable into up to ``slice_count`` blocks
    (reference ``transpiler/distribute_transpiler.py:79 slice_variable``
    — there the blocks are pserver shards; here they are the ZeRO
    dp-rank shards the kReduce strategy assigns, so the same accounting
    answers "which rank owns which slice of optimizer state").

    Returns ``[(name, block_id, block_numel)]``.  Variables under
    ``min_block_size`` stay whole (one block); split counts never exceed
    the first-dimension extent, and blocks differ by at most one
    first-dim row — the even-split rule of the mesh's shards.
    """
    blocks = []
    for var in var_list:
        shape = tuple(var.shape or ())
        numel = int(np.prod(shape)) if shape else 1
        if numel < min_block_size or not shape or shape[0] <= 1 \
                or slice_count <= 1:
            blocks.append((var.name, 0, numel))
            continue
        k = min(slice_count, int(shape[0]))
        row = numel // int(shape[0])
        base, extra = divmod(int(shape[0]), k)
        for b in range(k):
            rows = base + (1 if b < extra else 0)
            blocks.append((var.name, b, rows * row))
    return blocks


class DistributeTranspilerConfig:
    """reference distribute_transpiler.py:125."""

    def __init__(self):
        self.slice_var_up = True
        # a ps_dispatcher class or its name: decides which shard owner
        # each sliced block lands on (see placement())
        self.split_method = "RoundRobin"
        self.min_block_size = 8192         # reference's slicing threshold


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._program = None
        self._plan = None
        self._placement = None

    # ------------------------------------------------------------------
    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, mesh=None):
        """Build the sharding plan.  ``pservers``/``sync_mode`` are taken
        for API parity; async pserver SGD has no counterpart (every
        update is a synchronous mesh-wide step) and pserver endpoints are
        subsumed by the mesh."""
        if not sync_mode:
            raise NotImplementedError(
                "async pserver SGD has no counterpart in the mesh runtime: "
                "updates are synchronous mesh-wide steps")
        # validate the dispatcher BEFORE any state lands on self, so a
        # failed transpile leaves the object cleanly un-transpiled
        from . import ps_dispatcher
        method = self.config.split_method
        if isinstance(method, str):
            method = getattr(ps_dispatcher, method, None)
        if not (isinstance(method, type) and
                issubclass(method, ps_dispatcher.PSDispatcher)):
            raise ValueError(
                "split_method must be a PSDispatcher subclass or its "
                "name, got %r" % (self.config.split_method,))
        self._program = program or default_main_program()
        self.trainer_id = trainer_id
        self.trainers = trainers
        self._mesh = mesh

        dist_tables = set(distributed_tables(self._program))

        plan = {}
        for p in self._program.all_parameters():
            shape = tuple(p.shape or ())
            numel = int(np.prod(shape)) if shape else 0
            if p.name in dist_tables:
                plan[p.name] = ("table", P(AXIS_EP))
            elif self.config.slice_var_up and shape and \
                    numel >= self.config.min_block_size:
                plan[p.name] = ("sliced", P(AXIS_DP))
            else:
                plan[p.name] = ("replicated", P())
        self._plan = plan

        # block -> shard-owner placement via the configured dispatcher
        # (reference ps_dispatcher.py: block -> pserver endpoint).  The
        # owners are the pserver endpoints when given (parity surface)
        # or the dp ranks of the plan otherwise.
        owners = [e.strip() for e in (pservers or "").split(",")
                  if e.strip()]
        if not owners:
            owners = ["dp:%d" % r for r in range(max(1, int(trainers)))]
        dispatcher = method(owners)
        sliced = [p for p in self._program.all_parameters()
                  if plan[p.name][0] == "sliced"]
        whole = [p for p in self._program.all_parameters()
                 if plan[p.name][0] != "sliced"]
        blocks = slice_variable(sliced, len(owners),
                                self.config.min_block_size) + \
            [(p.name, 0, int(np.prod(tuple(p.shape or ()) or (1,))))
             for p in whole]
        keys = ["%s.block%d" % (name, bid) for name, bid, _ in blocks]
        self._placement = dict(zip(keys, dispatcher.dispatch(keys)))
        return self

    def placement(self):
        """{``name.blockN``: owner} — which shard owner each param block
        lands on, per ``config.split_method`` (the reference's
        param→pserver endpoint map, inspectable like its transpiler
        tests inspect generated programs)."""
        if self._placement is None:
            raise RuntimeError("call transpile() first")
        return dict(self._placement)

    # ------------------------------------------------------------------
    def sharding_plan(self):
        """{param name: (kind, PartitionSpec)} — inspectable, like the
        reference's transpiler tests inspect generated programs."""
        if self._plan is None:
            raise RuntimeError("call transpile() first")
        return dict(self._plan)

    def build_strategy(self, mesh):
        """A BuildStrategy whose param_sharding_fn applies the plan,
        degrading to replication when a dim doesn't divide the mesh."""
        if self._plan is None:
            raise RuntimeError("call transpile() first")
        axis_sizes = dict(zip(mesh.axis_names, mesh.shape))
        plan = self._plan

        def fn(name, shape):
            kind_spec = plan.get(name)
            if kind_spec is None:
                return None
            _, spec = kind_spec
            entries = tuple(spec)
            if not entries:
                return P()
            # substitute dp for axes this mesh lacks FIRST, then check
            # divisibility against the axes actually used — an
            # indivisible dim degrades to replication, never to an
            # invalid spec
            fixed = tuple(
                (a if a in axis_sizes else AXIS_DP) if a else None
                for a in entries)
            for dim, axis in zip(shape, fixed):
                if axis is None:
                    continue
                size = axis_sizes.get(axis, 1)
                if size > 1 and (dim <= 0 or dim % size != 0):
                    return P()
            return P(*fixed)

        bs = BuildStrategy()
        bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
        bs.param_sharding_fn = fn
        return bs

    # ------------------------------------------------------------------
    def get_trainer_program(self):
        """The program is not rewritten: ``ParallelExecutor``'s plan
        places the collectives the reference expressed as send/recv
        ops."""
        if self._program is None:
            raise RuntimeError("call transpile() first")
        return self._program

    def get_pserver_program(self, endpoint):
        raise RuntimeError(
            "there is no parameter-server role in the mesh runtime: "
            "parameters live sharded on the mesh (use build_strategy(mesh) "
            "with a ParallelExecutor; multi-host joins via "
            "parallel.distributed.init_distributed)")

    get_pserver_programs = get_pserver_program

    def get_startup_program(self, endpoint=None, pserver_program=None):
        raise RuntimeError(
            "no pserver startup program exists: run the normal startup "
            "program on every host (deterministic seeded init gives "
            "identical parameters)")
