"""Model-health telemetry + NaN provenance (counterpart of
``paddle_tpu/monitor/health.py``).

* **The health probe** (``FLAGS_health``): per layer class the executor's
  step computes four float32 stats: gradient L2 norm, parameter L2 norm,
  update/param ratio ``||new - old|| / (||new|| + eps)`` and the
  non-finite gradient element count, as one ``(L, 4)`` tensor.
  Parameters fall into layer classes by the JAX package's
  program-structure scan (``classify_params``, its copy below):
  embedding / norm / mlp_col / mlp_row / mlp_bias, and "other" for a
  trained parameter the scan leaves out.  On the card the stats are
  computed *inside the captured step*: the graph copies each class's
  parameters into one vector at its start (the optimizer updates them in
  place), keeps their gradients to its end, reduces each class's
  concatenated tensors and writes the stats into a buffer of the entry's
  that outlives the graph's pool.  Nothing in the probe reads a
  value on the host, so the capture holds it and every replay recomputes
  it; the stats never feed the state math, so fetches and parameters are
  bit-equal with the flag on or off.  The stats reach the host only
  every ``FLAGS_health_every`` runs of the entry (``note_step``): gauges
  ``health/<layer>/*`` and a ``model_health`` JSONL record.  The probe
  is part of the executor's entry key, so flipping the flag makes new
  entries instead of serving a stale graph.
* **NaN provenance** (``nan_provenance``): the replay context of each
  probed step (program, scope, feeds, the generator's state) is kept in
  a small ring; a replay walks the program op by op on the executor's
  place (``transpiler.nan_debug.first_nonfinite_op``) and names the
  first op whose output is not finite.  ``check_nan_inf`` adds it to
  its error while the probe is on.

``tools/health_report.py`` renders the JSONL records as a per-layer
table.  The fleet alert rules over these gauges wait for the cluster
runtime (ROADMAP A7c).
"""

import collections
import time

import numpy as np

__all__ = [
    "enabled", "probe_enabled", "build_probe", "begin_step", "probe_stats",
    "note_step", "last_snapshot", "format_snapshot", "stamp",
    "nan_provenance", "HealthProbe", "classify_params",
]

# fast-path gate, same contract as monitor._enabled
_ENABLED = False
_EVERY = [10]

# last published per-layer snapshot (kept even while the monitor is off:
# watchdog stall dumps read it)
_SNAPSHOT = [None]

# per-step replay contexts for NaN provenance, step -> context dict
_REPLAY = collections.OrderedDict()
_REPLAY_MAX = 32

_EPS = 1e-12

# logical-axes tuple (classify_params) -> layer class label
_AXES_LABEL = {
    ("vocab", "embed"): "embedding",
    ("norm",): "norm",
    ("embed", "mlp"): "mlp_col",
    ("mlp", "embed"): "mlp_row",
    ("mlp",): "mlp_bias",
}

# ops through which a column-parallel output stays column-parallel
_PASSTHROUGH_OPS = {
    "relu", "gelu", "tanh", "sigmoid", "dropout", "scale", "reshape",
    "transpose", "fused_attention", "softmax", "cast",
}


def classify_params(program):
    """``{param: logical axes}`` from the ops that consume each parameter
    (the JAX package's ``parallel/spec_layout.classify_params``, copied):
    a ``lookup_table`` W is ("vocab", "embed"), a ``layer_norm``
    Scale/Bias ("norm",), a ``mul``/``matmul`` weight ("embed", "mlp")
    or, fed from a column-parallel output, ("mlp", "embed"); a 1-D bias
    added onto a column-parallel output ("mlp",), other 1-D biases
    ("norm",)."""
    classes = {}
    mlp_vars = set()
    for blk in program.blocks:
        for op in blk.ops:
            ins, outs = op.inputs, op.outputs
            if op.type == "lookup_table":
                for w in ins.get("W", ()):
                    classes[w] = ("vocab", "embed")
            elif op.type == "layer_norm":
                for slot in ("Scale", "Bias"):
                    for nm in ins.get(slot, ()):
                        classes[nm] = ("norm",)
            elif op.type in ("mul", "matmul"):
                xs = ins.get("X", ())
                for w in ins.get("Y", ()):
                    v = blk._find_var_recursive(w)
                    if v is None or not getattr(v, "persistable", False):
                        continue
                    row_par = any(x in mlp_vars for x in xs)
                    classes.setdefault(
                        w, ("mlp", "embed") if row_par else ("embed", "mlp"))
                    if classes[w] == ("embed", "mlp"):
                        mlp_vars.update(outs.get("Out", ()))
            elif op.type == "elementwise_add":
                xs = ins.get("X", ())
                col = any(x in mlp_vars for x in xs)
                for b in ins.get("Y", ()):
                    v = blk._find_var_recursive(b)
                    if v is not None and getattr(v, "persistable", False) \
                            and v.shape is not None and len(v.shape) == 1:
                        classes.setdefault(b, ("mlp",) if col else ("norm",))
                if col:
                    mlp_vars.update(outs.get("Out", ()))
            elif op.type in _PASSTHROUGH_OPS:
                if any(x in mlp_vars for x in
                       list(ins.get("X", ())) + list(ins.get("Q", ()))):
                    for names in outs.values():
                        mlp_vars.update(names)
    return classes


def _reconcile():
    """FLAGS_health family on_set hook."""
    from .. import flags

    global _ENABLED
    try:
        _ENABLED = bool(flags.flag("health"))
        _EVERY[0] = max(1, int(flags.flag("health_every")))
    except KeyError:
        # import-time env override: the sibling flag registers a beat
        # later, and its own hook runs this again
        pass
    if not _ENABLED:
        _REPLAY.clear()


def enabled():
    return _ENABLED


def probe_enabled():
    """Whether new executor entries carry the probe (part of the entry
    key)."""
    return _ENABLED


class HealthProbe:
    """One entry's probe plan: layer classes in publication order, the
    ``(param, grad-or-None)`` members of each, the gradient vars the step
    keeps to its end, and the entry's stats buffer (``buffer``, made at
    the capture; None for an eager entry)."""

    def __init__(self, labels, layers, grad_names):
        self.labels = labels
        self.layers = layers
        self.grad_names = grad_names
        self.param_labels = {p: lb for lb in labels
                             for p, _ in layers[lb]}
        self.params = [p for lb in labels for p, _ in layers[lb]]
        self.buffer = None
        self.runs = 0     # the entry's probed runs (the cadence's count)
        # a mesh runtime's program: (its MeshRuntime, {var: 1 / the var's
        # replicas}), so that the stats cover the global tensors
        self.mesh = None


def build_probe(program, state_names):
    """Plan the probe for an entry reading ``state_names``: which
    ``@GRAD`` vars to keep and which parameters each layer's norms read.
    None when the program trains nothing.  A program the mesh runtime
    planned is classified as the program it was planned from, and its
    stats sum every rank's shards (``probe_stats``)."""
    classes = classify_params(getattr(program, "_mesh_source", program))
    produced = set()
    for blk in program.blocks:
        for op in blk.ops:
            produced.update(n for n in op.output_arg_names if n)
    by_label = {}
    for p in state_names:
        g = p + "@GRAD"
        has_grad = g in produced
        label = _AXES_LABEL.get(classes.get(p))
        if label is None:
            if not has_grad:
                continue
            label = "other"
        by_label.setdefault(label, []).append((p, g if has_grad else None))
    if not by_label or not any(g for members in by_label.values()
                               for _, g in members):
        return None
    labels = sorted(by_label)
    grad_names = [g for lb in labels for _, g in by_label[lb]
                  if g is not None]
    probe = HealthProbe(labels, by_label, grad_names)
    rt = getattr(program, "_mesh_runtime", None)
    if rt is not None and rt.mesh.size > 1:
        probe.mesh = (rt, getattr(program, "_mesh_weights", {}))
    return probe


def _flat(tensors):
    """One float32 vector of ``tensors`` (a copy: ``torch.cat``).  A
    SelectedRows gradient (``is_sparse``) enters as its merged rows: the
    dense gradient's nonzero rows."""
    import torch

    from ..ops.selected_rows import SelectedRows, merge_rows

    flat = []
    for t in tensors:
        if isinstance(t, SelectedRows):
            t = merge_rows(t)[1]
        flat.append(t.reshape(-1).to(torch.float32))
    return torch.cat(flat)


def begin_step(probe, env, writeback):
    """At the start of the step: each layer class's parameters that the
    step writes back (the optimizer updates them in place), copied into
    one float32 vector a class, ``{label: (names, vector)}``."""
    old = {}
    for label in probe.labels:
        names = [p for p, _ in probe.layers[label]
                 if p in writeback and p in env]
        if names:
            old[label] = (names, _flat([env[p] for p in names]))
    return old


def probe_stats(probe, env, old):
    """At the end of the step: the ``(L, 4)`` float32 stats tensor on the
    step's device, from the kept gradients, the parameters as they stand
    and ``old`` (``begin_step``).  Each layer class's tensors are
    concatenated into one vector first, so a step adds a few kernels a
    class rather than a few a parameter (~250 parameters in
    Transformer-base).  Device arithmetic only: no value comes to the
    host, so a CUDA graph holds it."""
    import torch

    if probe.mesh is not None:
        return _mesh_stats(probe, env, old)
    rows = []
    zero = None
    for label in probe.labels:
        members = probe.layers[label]
        grads = [env[g] for _, g in members if g is not None and g in env]
        params = [env[p] for p, _ in members if p in env]
        if zero is None:
            ref = (params or grads)[0]
            zero = torch.zeros((), dtype=torch.float32, device=ref.device)
        gsq = nf = psq = usq = zero
        if grads:
            gv = _flat(grads)
            gsq = torch.sum(gv * gv)
            nf = torch.sum((~torch.isfinite(gv)).to(torch.float32))
        if params:
            pv = _flat(params)
            psq = torch.sum(pv * pv)
        if label in old:
            names, before = old[label]
            dv = _flat([env[p] for p in names]) - before
            usq = torch.sum(dv * dv)
        pn = torch.sqrt(psq)
        rows.append(torch.stack([torch.sqrt(gsq), pn,
                                 torch.sqrt(usq) / (pn + _EPS), nf]))
    stats = torch.stack(rows)
    if probe.buffer is not None:
        probe.buffer.copy_(stats)
        return probe.buffer
    return stats


def _mesh_stats(probe, env, old):
    """``probe_stats`` over a mesh: each rank's sums of squares and
    non-finite counts, a var's weighted by 1 / its replicas (a shard
    counts whole, a replicated var once over the world), summed over the
    world, then the norms: every rank gets the global tensors' stats."""
    import torch

    rt, weights = probe.mesh
    sums = []
    for label in probe.labels:
        members = probe.layers[label]
        row = [torch.zeros((), dtype=torch.float32, device=rt.device)
               for _ in range(4)]
        for p, g in members:
            if g is not None and g in env:
                gv = _flat([env[g]])
                w = float(weights.get(g, 1.0))
                row[0] = row[0] + w * torch.sum(gv * gv)
                row[3] = row[3] + w * torch.sum(
                    (~torch.isfinite(gv)).to(torch.float32))
            if p in env:
                pv = _flat([env[p]])
                row[1] = row[1] + float(weights.get(p, 1.0)) \
                    * torch.sum(pv * pv)
        if label in old:
            names, before = old[label]
            at = 0
            for p in names:
                now = _flat([env[p]])
                dv = now - before[at:at + now.numel()]
                at += now.numel()
                row[2] = row[2] + float(weights.get(p, 1.0)) \
                    * torch.sum(dv * dv)
        sums.append(torch.stack(row))
    sums = rt.all_reduce(torch.stack(sums), rt.mesh.axis_names)
    pn = torch.sqrt(sums[:, 1])
    stats = torch.stack([torch.sqrt(sums[:, 0]), pn,
                         torch.sqrt(sums[:, 2]) / (pn + _EPS),
                         torch.round(sums[:, 3])], dim=1)
    if probe.buffer is not None:
        probe.buffer.copy_(stats)
        return probe.buffer
    return stats


def note_step(executor_name, step, probe, stats, program=None,
              scope=None, generator_state=None, feed_names=(),
              feed_vals=(), place=None):
    """One probed executor step (``step``: the executor's run index)
    completed.  Always keeps the NaN replay context (references and the
    generator state; no device sync); publishes the per-layer snapshot
    every ``FLAGS_health_every`` runs of the probed entry, its first run
    included, where the stats come to the host (the probe's only host
    read).  The JAX package counts the executor's runs; counting the
    entry's keeps the cadence when one executor interleaves programs or
    scopes."""
    from . import enabled as _mon_enabled, log_event, registry

    if not _ENABLED:
        return None
    step = int(step)
    _REPLAY[step] = {
        "executor": executor_name, "program": program, "scope": scope,
        "generator_state": generator_state,
        "feed_names": tuple(feed_names), "feed_vals": list(feed_vals),
        "place": place, "labels": probe.param_labels,
    }
    while len(_REPLAY) > _REPLAY_MAX:
        _REPLAY.popitem(last=False)
    probe.runs += 1
    if (probe.runs - 1) % _EVERY[0]:
        return None
    arr = stats.detach().cpu().numpy().astype(np.float64)
    snap = {"event": "model_health", "ts": time.time(),
            "executor": executor_name, "step": step, "layers": {}}
    for i, label in enumerate(probe.labels):
        gn, pn, ur, nf = (float(arr[i, 0]), float(arr[i, 1]),
                          float(arr[i, 2]), int(arr[i, 3]))
        snap["layers"][label] = {
            "grad_norm": gn, "param_norm": pn,
            "update_ratio": ur, "nonfinite": nf}
    _SNAPSHOT[0] = snap
    if _mon_enabled():
        reg = registry()
        for label, d in snap["layers"].items():
            base = "health/%s/" % label
            for k in ("grad_norm", "param_norm", "update_ratio"):
                reg.gauge(base + k).set(float(d[k]))
            reg.gauge(base + "nonfinite").set(float(d["nonfinite"]))
    log_event(dict(snap, layers={k: dict(v)
                                 for k, v in snap["layers"].items()}))
    return snap


def last_snapshot():
    return _SNAPSHOT[0]


def format_snapshot(snap=None):
    """One compact line per layer for error messages and stall dumps."""
    snap = snap if snap is not None else _SNAPSHOT[0]
    if not snap:
        return ""
    parts = []
    for label in sorted(snap.get("layers", {})):
        d = snap["layers"][label]
        parts.append("%s grad_norm=%.3g update_ratio=%.3g nonfinite=%d"
                     % (label, d["grad_norm"], d["update_ratio"],
                        d["nonfinite"]))
    return "step %d: %s" % (snap.get("step", -1), "; ".join(parts))


def stamp():
    """Log the last snapshot as a ``model_health`` JSONL record (the
    Trainer stamps it at the end of training) and return it."""
    from . import log_event

    snap = _SNAPSHOT[0]
    if snap is not None:
        log_event(dict(snap, ts=time.time(),
                       layers={k: dict(v)
                               for k, v in snap["layers"].items()}))
    return snap


def _clear_for_tests():
    _REPLAY.clear()
    _SNAPSHOT[0] = None


def nan_provenance(step, feed=None):
    """Replay the kept context of ``step`` (``feed``, when given, a
    ``(names, values)`` pair, replaces its feeds) op by op and name the
    first op whose output is not finite.  Returns a JSON-safe record
    (``found`` False when every output stays finite), or None when the
    probe is off or the step is not in the ring.  Never raises: it runs
    on an error path and must not mask the error."""
    if not _ENABLED:
        return None
    ctx = _REPLAY.get(int(step))
    if ctx is None:
        return None
    from ..transpiler import nan_debug

    names, vals = (feed if feed is not None
                   else (ctx["feed_names"], ctx["feed_vals"]))
    rec = {"step": int(step), "executor": ctx["executor"], "found": False}
    t0 = time.perf_counter()
    try:
        hit = nan_debug.first_nonfinite_op(
            ctx["program"], dict(zip(names, vals)), ctx["scope"],
            place=ctx["place"], generator_state=ctx["generator_state"],
            classify=ctx["labels"])
    except Exception as e:  # noqa: BLE001 — diagnostics must not mask
        rec["error"] = repr(e)
        hit = None
    rec["replay_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    if hit is not None:
        rec.update(hit)
        rec["found"] = True
    return rec
