"""Pipeline parallelism: microbatched stages over the mesh's ``pp`` axis,
under a selectable schedule (counterpart of
``paddle_tpu/parallel/pipeline.py``).

Layers are grouped into stages; the batch splits into M microbatches;
rank d of the ``pp`` group applies stage d (or, under ``interleaved``,
its v stage chunks) and the activations travel stage to stage by
point-to-point transfers.  Where the JAX package runs every schedule as
one ``lax.fori_loop`` under ``shard_map`` (each device computing masked
garbage on its idle ticks), each rank here runs a tick loop of its own:
at the start of a tick it posts that tick's transfers in one
``batch_isend_irecv`` (``MeshRuntime.exchange``; the same order on every
rank, so no two ranks wait on each other), then computes the stage it
holds at that tick, if any.  The last stage's outputs reach every ``pp``
rank by one broadcast, as the JAX package's ``out_specs P(pp)`` slice
delivers a single-source broadcast.

Schedules (GPipe, Huang et al.; 1F1B / interleaved, Narayanan et al.):

``gpipe``
    fill-drain: M + S - 1 forward ticks keeping every (stage, microbatch)
    autograd graph, then M + S - 1 backward ticks retiring them in
    reverse, the cotangents flowing down the ring.
``1f1b``
    a stash-free forward (the same M + S - 1 ticks, no graph kept), then
    one combined backward of M + 2(S - 1) ticks: each tick recomputes one
    stage forward just in time (stashing its INPUT; at most
    min(M, 2S - 1) inputs are held, whatever M) and retires one stage
    backward with ``torch.autograd.grad`` from the stashed input.
``interleaved``
    v = S_total / pp chunks a rank (chunk r of rank d is stage r*pp + d);
    groups of pp microbatches ride the ring v times, vM + pp - 1 ticks.
    Needs S_total % pp == 0 and M % pp == 0.

The backward of every schedule is a ``torch.autograd.Function``: a
stage's parameter gradients are made on the rank that holds the stage,
the carry's on the first stage's rank, a side input's on every rank for
its own stages; one all-reduce (sum) over ``pp`` of all of them, zeros
from the ranks that do not hold a stage, gives every rank the gradients
the sequential fold gives, so a replicated optimizer takes the
single-device update.

Surface:

* ``pipeline(stage_fn, stage_params, x, mesh, axis='pp',
  microbatches=M, schedule='gpipe')``: ``stage_fn(params, x) -> y`` is one
  stage (y shaped as x); ``stage_params`` a pytree whose leaves have the
  leading stage dim S_total; returns stage_{S-1}(... stage_0(x)) on every
  rank, differentiable;
* ``run_schedule``: the engine the ``pipeline_region`` op shares;
* ``schedule_stats(schedule, stages, microbatches, virtual=1)``: the
  per-tick stage-idle accounting of the JAX package (the goodput ledger's
  ``pipeline_bubble`` bucket and ``autotune.tune_pipeline`` read it);
* ``LAST_RUN``: this rank's counts of its last forward and backward run
  (ticks, point-to-point transfers posted, the 1F1B stash's peak).
"""

import torch

from .mesh import AXIS_PP

__all__ = ["pipeline", "run_schedule", "SCHEDULES", "schedule_stats",
           "normalize_schedule", "region_plan", "interleaved_order",
           "LAST_RUN"]

SCHEDULES = ("gpipe", "1f1b", "interleaved")

# this rank's counts of its last run: {"forward": {...}, "backward": {...}}
LAST_RUN = {}


def normalize_schedule(schedule):
    """``None`` -> the default ``gpipe``; anything else must name a
    known schedule."""
    if schedule is None:
        return "gpipe"
    if schedule not in SCHEDULES:
        raise ValueError("unknown pipeline schedule %r (choose from %s)"
                         % (schedule, list(SCHEDULES)))
    return schedule


def schedule_stats(schedule, stages, microbatches, virtual=1):
    """Per-device slot accounting for one fwd+bwd step of a schedule (the
    JAX package's, copied): one forward stage application is 1 unit, one
    backward 2; ``idle_units / total_units`` is the share of the step the
    schedule leaves a stage idle.  1F1B's just-in-time recompute counts
    busy and is reported as ``remat_units``; ``in_flight`` counts the
    stashed activation sets."""
    schedule = normalize_schedule(schedule)
    s = int(stages)
    m = int(microbatches)
    v = int(virtual or 1)
    if s < 1 or m < 1 or v < 1:
        raise ValueError("stages/microbatches/virtual must be >= 1")
    remat = 0
    if schedule == "gpipe":
        total = 3 * (m + s - 1)
        idle = 3 * (s - 1)
        in_flight = m + s - 1
        ticks = m + s - 1
    elif schedule == "interleaved":
        ticks = v * m + s - 1
        total = 3 * ticks
        idle = 3 * (s - 1)
        in_flight = ticks
    else:  # 1f1b
        bwd_ticks = m + 2 * (s - 1)
        total = (m + s - 1) + 3 * bwd_ticks
        idle = (s - 1) + 3 * 2 * (s - 1)
        remat = m
        in_flight = min(m, 2 * s - 1)
        ticks = (m + s - 1) + bwd_ticks
    return {"schedule": schedule, "stages": s, "microbatches": m,
            "virtual": v, "ticks": ticks, "total_units": total,
            "idle_units": idle, "remat_units": remat,
            "in_flight": in_flight,
            "bubble_fraction": idle / total if total else 0.0}


def region_plan(attrs, schedule, pp, microbatches=None):
    """How a ``pipeline_region`` op with ``attrs`` runs ``schedule`` over a
    ``pp`` axis of that extent: ``(v, m)``.  ``v`` is the stage chunks a
    rank holds, 0 where the region runs its sequential path (gpipe and
    1f1b need one stage a rank, interleaved a multiple of the extent: the
    JAX lowering's engagement test).  ``m`` is the microbatch count:
    ``microbatches`` (``BuildStrategy.pipeline_microbatches``) over the
    attr, else one a stage.  Raises where the interleaved schedule would
    run M not a multiple of the extent.  The op, ``ParallelExecutor``'s
    bubble accounting and ``autotune.tune_pipeline`` all decide by it."""
    stages = int(attrs["stages"])
    m = int(microbatches or attrs.get("microbatches") or stages)
    schedule = normalize_schedule(schedule)
    if pp <= 1 or stages <= 1:
        v = 0
    elif schedule == "interleaved":
        v = 0 if stages % pp else stages // pp
    else:
        v = 1 if stages == pp else 0
    if v and schedule == "interleaved" and m % pp:
        raise ValueError(
            "pipeline_region: the interleaved schedule sends groups of "
            "S microbatches around the ring together — microbatches "
            "(%d) must be a multiple of the pp axis size (%d)" % (m, pp))
    return v, m


def interleaved_order(s, v):
    """Device-major order of the interleaved schedule: slot ``d*v + r``
    holds virtual stage ``r*s + d`` (device d's chunk r)."""
    return [r * s + d for d in range(s) for r in range(v)]


class _Schedule:
    """One rank's part of a schedule: its tick loops forward and
    backward.  ``apply(vs, params, carry, fsides_t, mb) -> out`` applies
    program stage ``vs`` to microbatch ``mb``'s carry (``fsides_t``: the
    float side inputs' slices of that microbatch)."""

    def __init__(self, schedule, rt, axis, stage_params, m, virtual, apply,
                 out_dtype):
        self.schedule = schedule
        self.rt, self.axes = rt, (axis,)
        self.s, self.d = rt.extent(self.axes), rt.index(self.axes)
        self.m, self.v = int(m), int(virtual)
        self.apply = apply
        self.n_params = [len(p) for p in stage_params]
        self.out_dtype = out_dtype
        self.transfers = 0
        self.stash_peak = 0

    def _xchg(self, sends, recvs):
        self.transfers += self.rt.exchange(self.axes, sends, recvs)

    def _empty(self, like):
        return torch.empty(like.shape, dtype=self.out_dtype,
                           device=like.device)

    def _leaves(self, params, cache, vs):
        if vs not in cache:
            cache[vs] = [p.detach().requires_grad_(p.is_floating_point())
                         for p in params[vs]]
        return cache[vs]

    def _run(self, vs, params, inp, fsides, mb, saved, cache):
        """Stage ``vs`` on microbatch ``mb``: with ``saved`` (a dict) under
        autograd, its graph kept for the backward; else without one."""
        fs_t = [f[mb] for f in fsides]
        if saved is None:
            with torch.no_grad():
                return self.apply(vs, params[vs], inp, fs_t, mb).to(
                    self.out_dtype)
        with torch.enable_grad():
            pl = self._leaves(params, cache, vs)
            c = inp.detach().requires_grad_()
            fl = [f.detach().requires_grad_() for f in fs_t]
            out = self.apply(vs, pl, c, fl, mb).to(self.out_dtype)
        saved[(vs, mb)] = (pl, c, fl, out)
        return out.detach()

    def _retire(self, entry, ct, vs, mb, dparams, dfs):
        """One stage backward: accumulates the stage's parameter and side
        gradients, returns the carry's."""
        pl, c, fl, out = entry
        leaves = list(pl) + [c] + list(fl)
        grads = torch.autograd.grad(out, leaves, ct.to(out.dtype),
                                    allow_unused=True)
        k = len(pl)
        for j, gp in enumerate(grads[:k]):
            if gp is not None:
                dparams[vs][j] = dparams[vs][j] + gp
        for j, gf in enumerate(grads[k + 1:]):
            if gf is not None:
                dfs[j][mb] += gf.to(dfs[j].dtype)
        dc = grads[k]
        return torch.zeros_like(c) if dc is None else dc

    # -- forward -----------------------------------------------------------
    def forward(self, x_mb, params, fsides, keep):
        saved = {} if keep else None
        cache = {}
        self.transfers = 0
        if self.schedule == "interleaved":
            outs = self._interleaved_fwd(x_mb, params, fsides, saved, cache)
            ticks = self.v * self.m + self.s - 1
        else:
            outs = self._fill_drain_fwd(x_mb, params, fsides, saved, cache)
            ticks = self.m + self.s - 1
        last = self.s - 1
        if self.d == last:
            full = torch.stack(outs)
        else:
            full = torch.empty((self.m,) + tuple(x_mb.shape[1:]),
                               dtype=self.out_dtype, device=x_mb.device)
        self.rt.broadcast(full, self.axes, last)
        LAST_RUN["forward"] = {"schedule": self.schedule, "ticks": ticks,
                               "transfers": self.transfers,
                               "kept_graphs": len(saved or {})}
        return full, saved

    def _fill_drain_fwd(self, x_mb, params, fsides, saved, cache):
        s, d, m = self.s, self.d, self.m
        outs = [None] * m
        prev = None
        for t in range(m + s - 1):
            mb = t - d
            active = 0 <= mb < m
            sends = [(prev, d + 1)] if prev is not None else []
            buf = self._empty(x_mb[0]) if active and d > 0 else None
            self._xchg(sends, [(buf, d - 1)] if buf is not None else [])
            prev = None
            if active:
                inp = x_mb[mb].to(self.out_dtype) if d == 0 else buf
                out = self._run(d, params, inp, fsides, mb, saved, cache)
                if d == s - 1:
                    outs[mb] = out
                else:
                    prev = out
        return outs

    def _interleaved_item(self, t):
        s, v, d = self.s, self.v, self.d
        q = t - self.d
        rnd = (q // s) % v
        grp = q // (s * v)
        midx = grp * s + q % s
        active = q >= 0 and grp < self.m // s
        return active, rnd, midx, rnd * s + d

    def _interleaved_fwd(self, x_mb, params, fsides, saved, cache):
        s, d, v = self.s, self.d, self.v
        outs = [None] * self.m
        prev = None
        for t in range(v * self.m + s - 1):
            active, rnd, midx, vs = self._interleaved_item(t)
            sends = [(prev, (d + 1) % s)] if prev is not None else []
            fresh = d == 0 and rnd == 0
            buf = self._empty(x_mb[0]) if active and not fresh else None
            self._xchg(sends, [(buf, (d - 1) % s)] if buf is not None
                       else [])
            prev = None
            if active:
                inp = x_mb[midx].to(self.out_dtype) if fresh else buf
                out = self._run(vs, params, inp, fsides, midx, saved, cache)
                if d == s - 1 and rnd == v - 1:
                    outs[midx] = out
                else:
                    prev = out
        return outs

    # -- backward ----------------------------------------------------------
    def backward(self, g, x_mb, params, fsides, saved):
        self.transfers = 0
        self.stash_peak = 0
        dparams = {vs: [torch.zeros_like(p) for p in ps]
                   for vs, ps in enumerate(params)}
        dfs = [torch.zeros_like(f) for f in fsides]
        dx = torch.zeros(x_mb.shape, dtype=self.out_dtype,
                         device=x_mb.device)
        if self.schedule == "1f1b":
            ticks = self._1f1b_bwd(g, x_mb, params, fsides, dparams, dfs, dx)
        elif self.schedule == "interleaved":
            ticks = self._interleaved_bwd(g, saved, dparams, dfs, dx)
        else:
            ticks = self._gpipe_bwd(g, saved, dparams, dfs, dx)
        # one sum over pp: each gradient is made on its stage's rank only
        flat = [dx] + [t for vs in range(len(params)) for t in dparams[vs]] \
            + dfs
        sizes = [t.numel() for t in flat]
        dtypes = {t.dtype for t in flat}
        if len(dtypes) == 1:
            buf = torch.cat([t.reshape(-1) for t in flat])
            self.rt.all_reduce(buf, self.axes)
            flat = [c.reshape(t.shape) for c, t in
                    zip(torch.split(buf, sizes), flat)]
        else:
            flat = [self.rt.all_reduce(t.contiguous(), self.axes)
                    for t in flat]
        LAST_RUN["backward"] = {"schedule": self.schedule, "ticks": ticks,
                                "transfers": self.transfers,
                                "stash_peak": self.stash_peak}
        return flat

    def _gpipe_bwd(self, g, saved, dparams, dfs, dx):
        s, d, m = self.s, self.d, self.m
        prev = None
        for u in range(m + s - 1):
            k = u - (s - 1 - d)
            mb = m - 1 - k
            active = 0 <= k < m
            sends = [(prev, d - 1)] if prev is not None else []
            buf = self._empty(g[0]) if active and d < s - 1 else None
            self._xchg(sends, [(buf, d + 1)] if buf is not None else [])
            prev = None
            if active:
                ct = g[mb] if d == s - 1 else buf
                dc = self._retire(saved.pop((d, mb)), ct, d, mb, dparams,
                                  dfs)
                if d == 0:
                    dx[mb] = dc
                else:
                    prev = dc
        return m + s - 1

    def _interleaved_bwd(self, g, saved, dparams, dfs, dx):
        s, d, v = self.s, self.d, self.v
        total = v * self.m + s - 1
        prev = None
        for t in reversed(range(total)):
            active, rnd, midx, vs = self._interleaved_item(t)
            final = d == s - 1 and rnd == v - 1
            sends = [(prev, (d - 1) % s)] if prev is not None else []
            buf = self._empty(g[0]) if active and not final else None
            self._xchg(sends, [(buf, (d + 1) % s)] if buf is not None
                       else [])
            prev = None
            if active:
                ct = g[midx] if final else buf
                dc = self._retire(saved.pop((vs, midx)), ct, vs, midx,
                                  dparams, dfs)
                if d == 0 and rnd == 0:
                    dx[midx] = dc
                else:
                    prev = dc
        return total

    def _1f1b_bwd(self, g, x_mb, params, fsides, dparams, dfs, dx):
        s, d, m = self.s, self.d, self.m
        slots = min(m, 2 * s - 1) if s > 1 else 1
        stash, cache = {}, {}
        fprev = bprev = None
        total = m + 2 * (s - 1)
        for t in range(total):
            fidx, bidx = t - d, t - 2 * (s - 1) + d
            fval, bval = 0 <= fidx < m, 0 <= bidx < m
            sends = []
            if fprev is not None:
                sends.append((fprev, d + 1))
            if bprev is not None:
                sends.append((bprev, d - 1))
            fbuf = self._empty(x_mb[0]) if fval and d > 0 else None
            bbuf = self._empty(g[0]) if bval and d < s - 1 else None
            recvs = [(b, p) for b, p in ((fbuf, d - 1), (bbuf, d + 1))
                     if b is not None]
            self._xchg(sends, recvs)
            fprev = bprev = None
            if fval:
                # forward slot: stash the input, recompute the stage just
                # in time for the next rank (the last rank's output is
                # recomputed by its backward slot)
                finp = x_mb[fidx].to(self.out_dtype) if d == 0 else fbuf
                if any(k % slots == fidx % slots for k in stash):
                    raise RuntimeError("1f1b stash slot %d still held"
                                       % (fidx % slots))
                stash[fidx] = finp
                self.stash_peak = max(self.stash_peak, len(stash))
                if d < s - 1:
                    fprev = self._run(d, params, finp, fsides, fidx, None,
                                      cache)
            if bval:
                saved_in = stash.pop(bidx)
                ct = g[bidx] if d == s - 1 else bbuf
                entry = {}
                self._run(d, params, saved_in, fsides, bidx, entry, cache)
                dc = self._retire(entry[(d, bidx)], ct, d, bidx, dparams,
                                  dfs)
                if d == 0:
                    dx[bidx] = dc
                else:
                    bprev = dc
        return total


class _Pipelined(torch.autograd.Function):
    """A schedule's forward and backward as one differentiable call over
    (x_mb, every stage's parameters, the float side inputs)."""

    @staticmethod
    def forward(ctx, sched, keep, x_mb, *rest):
        params, fsides = _unflatten(sched, rest)
        out, saved = sched.forward(x_mb, params, fsides, keep)
        ctx.sched, ctx.saved = sched, saved
        ctx.save_for_backward(x_mb, *rest)
        return out

    @staticmethod
    def backward(ctx, g):
        x_mb, *rest = ctx.saved_tensors
        sched = ctx.sched
        params, fsides = _unflatten(sched, rest)
        flat = sched.backward(g.contiguous(), x_mb, params, fsides,
                              ctx.saved)
        ctx.saved = None
        grads = [flat[0].to(x_mb.dtype)]
        for t, r in zip(flat[1:], rest):
            grads.append(t.to(r.dtype))
        return (None, None) + tuple(grads)


def _unflatten(sched, rest):
    params, i = [], 0
    for n in sched.n_params:
        params.append(list(rest[i:i + n]))
        i += n
    return params, list(rest[i:])


def run_schedule(schedule, rt, axis, x_mb, stage_params, apply, fsides=(),
                 virtual=1, out_dtype=None):
    """Run ``schedule`` over ``rt``'s ``axis``: ``x_mb`` [M, mb, ...] the
    microbatched carry, ``stage_params`` a list (one entry a program stage)
    of parameter lists, ``fsides`` float side inputs [M, mb, ...],
    ``apply(vs, params, carry, fsides_t, mb) -> out``.  Returns the last
    stage's outputs [M, mb, ...] in ``out_dtype`` (default x's) on every
    rank; differentiable in x_mb, the parameters and the sides."""
    schedule = normalize_schedule(schedule)
    sched = _Schedule(schedule, rt, axis, stage_params, x_mb.shape[0],
                      virtual, apply, out_dtype or x_mb.dtype)
    flat = [p for ps in stage_params for p in ps] + list(fsides)
    keep = schedule != "1f1b" and torch.is_grad_enabled() and any(
        t.requires_grad for t in [x_mb] + flat)
    return _Pipelined.apply(sched, keep, x_mb, *flat)


def pipeline(stage_fn, stage_params, x, mesh, axis=AXIS_PP,
             microbatches=None, schedule="gpipe"):
    """Run ``stage_fn`` as an S-stage pipeline over ``mesh``'s ``axis``
    under ``schedule``.  ``stage_params`` leaves carry a leading stage dim
    (== the axis's extent; ``v *`` it for ``interleaved``); x [B, ...] is
    alike on every rank.  Returns stage_{S-1}(... stage_0(x)) on every
    rank.  Every rank of the world calls it."""
    from torch.utils import _pytree

    from . import distributed
    from .collective import MeshRuntime

    schedule = normalize_schedule(schedule)
    if axis not in mesh.axis_names:
        raise ValueError("mesh has no axis %r (axes: %s)"
                         % (axis, mesh.axis_names))
    s = mesh.axis_size(axis)
    leaves, spec = _pytree.tree_flatten(stage_params)
    s_total = leaves[0].shape[0] if leaves else s
    for leaf in leaves:
        if leaf.shape[0] != s_total:
            raise ValueError(
                "stage_params leaves disagree on the leading stage dim "
                "(%d vs %d)" % (leaf.shape[0], s_total))
    if schedule == "interleaved":
        if s_total % s:
            raise ValueError(
                "interleaved schedule: stage count %d must be a "
                "multiple of the %r axis size %d" % (s_total, axis, s))
        v = s_total // s
    else:
        v = 1
        if s_total != s:
            raise ValueError(
                "stage_params leading dim %d must equal the %r axis "
                "size %d (one stage per device; use "
                "schedule='interleaved' for v stages per device)"
                % (s_total, axis, s))
    m = microbatches or s
    if x.shape[0] % m != 0:
        raise ValueError("microbatches (%d) must divide the batch (%d)"
                         % (m, x.shape[0]))
    if schedule == "interleaved" and m % s:
        raise ValueError(
            "interleaved schedule: microbatches (%d) must be a "
            "multiple of the %r axis size %d (groups of S go around "
            "the ring together)" % (m, axis, s))
    mb_shape = (x.shape[0] // m,) + tuple(x.shape[1:])

    def stage_tree(params):
        return _pytree.tree_unflatten(list(params), spec)

    rt = MeshRuntime(mesh, distributed.process_id(), x.device)
    rt.prepare([(axis,)])
    my_stage = rt.index((axis,))
    with torch.no_grad():
        # the carries run in the stage's output dtype (float32 parameters
        # over bf16 activations promote)
        probe = stage_fn(stage_tree([p[my_stage] for p in leaves]),
                         x[:mb_shape[0]])
    if tuple(probe.shape) != mb_shape:
        raise ValueError(
            "stage_fn must preserve the activation shape so microbatches "
            "can flow stage-to-stage: input %s -> output %s"
            % (mb_shape, tuple(probe.shape)))
    out_dtype = probe.dtype
    stage_params = [[p[vs] for p in leaves] for vs in range(s_total)]
    x_mb = x.reshape((m,) + mb_shape).to(out_dtype)

    def apply(vs, params, carry, fsides_t, mb):
        return stage_fn(stage_tree(params), carry)

    out = run_schedule(schedule, rt, axis, x_mb, stage_params, apply,
                       virtual=v, out_dtype=out_dtype)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))
