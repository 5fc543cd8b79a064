"""Exact-resume TrainState checkpoints (counterpart of the TrainState half
of ``paddle_tpu/parallel/checkpoint.py``).

A ``TrainState`` is one atomic snapshot of a training run at a step
boundary: every persistable variable of the program (parameters,
optimizer moments, learning-rate and step counters, batch-norm running
statistics) as a private host copy, plus the JSON-able host state: the
step, each executor's ``state_dict()`` (its run counter and the state of
each of its ``torch.Generator``s, so a restored run draws the same
dropout masks) and each reader's position.

**Artifacts.**  ``save_train_state`` writes ``step_<n>/`` as the JAX
package does: ``arrays.npz`` (positional members, their names in
``train_state.json``), ``train_state.json`` and a ``MANIFEST.json`` with
each file's sha256, assembled in a ``.tmp.`` sibling and committed by one
directory rename.  A crash at any point leaves the older artifacts and at
most a ``.tmp.`` directory that restores ignore.  bfloat16 (which numpy
lacks) is stored as same-width unsigned integers with its logical name in
``raw_dtypes``, as the JAX package stores its ``ml_dtypes`` arrays, so
either package reads the other's arrays bit for bit.  Executor state is
each package's own: the JAX executor's is its run counter, the port's
adds its generators' states.

**Snapshots never alias live state.**  The port's optimizers update their
tensors in place and a captured step writes into bound buffers, so
``capture_train_state`` copies every value to the host before it returns
(a blocking copy on the current stream, the one the executor replays on);
the asynchronous writer serializes only that private copy.

**The manager.**  ``TrainStateCheckpointManager`` saves every
``save_interval_steps`` steps: the snapshot on the caller's thread, the
write (npz, fsync, manifest, commit, rotation) on a background thread,
which a later call joins; ``save_now`` is the synchronous flush of a
preemption.  ``restore`` takes the newest artifact that passes its
manifest check and falls back past torn or corrupt ones, and
``CheckpointMismatchError`` stops it where an intact artifact does not fit
the program.  With ``incremental=`` the ``is_sparse`` tables and their
row-wise optimizer slots are written as bitwise row deltas against the
previous artifact, with a full base every ``incremental_full_every``
artifacts; ``load`` replays the chain and rotation keeps every artifact a
kept delta needs.

**Across a mesh.**  ``capture_train_state`` with a ``ParallelExecutor``
among its ``executors`` gathers every var it holds split whole (a
collective: every rank captures), and the full artifact is written by
rank 0 alone; ``apply_train_state(shardings=pe.state_shardings())`` puts
each rank's shard of a whole artifact in the scope (without
``shardings`` the executor cuts whole values at its next run).

**Sharded artifacts.**  ``capture_train_state(..., sharded=True)`` copies
out only the blocks this rank owns (``ParallelExecutor.owned_shards``: a
split var's block on the rank at coordinate 0 of every mesh axis its spec
does not use, a whole var on rank 0), with no collective, so each rank
writes 1/N of the state.  The layout is the JAX package's, byte for byte:

    step_0000000012/
      shard_00000.npz    writer 0's blocks, positional members arr_i
                         (and rows_i, a delta's global row ids)
      shard_00000.json   writer 0's sidecar: each entry's name and global
                         [[start, stop], ...] index, the npz's bytes and
                         sha256 (landed as .part, then renamed)
      shard_00001.npz    ...
      train_state.json   the host state and every var's global shape and
                         dtype (array_meta; raw_dtype for bfloat16)
      MANIFEST.json      sharded, writers, per_writer_bytes, each file's
                         sha256, committed last by the elected saver

Every writer assembles into one shared ``.tmp.<name>.shared`` sibling;
the saver (``saver_elect``, default writer 0) polls for the sidecars,
writes the manifest and commits with one rename.  A load (any world size,
one process included) assembles full arrays from the shard files, so
``apply_train_state(shardings=...)`` re-shards onto whatever mesh
restores.  ``partition_shards`` splits one process's entries over N
virtual writers (the card run's stand-in for N hosts).  In incremental
mode each writer diffs only its own blocks and writes their changed rows
as global row ids.

``save_sharded``, ``load_sharded`` and ``ShardedCheckpointManager`` keep
the JAX package's orbax API over this same format (the port cannot import
orbax): each rank writes the blocks it owns, rank 0 commits, and a load
puts each rank's block of the assembled arrays in the scope.
"""

import collections
import hashlib
import json
import os
import shutil
import threading
import time
import warnings

import numpy as np
import torch

from .. import fault, monitor
from ..executor import _as_tensor
from ..profiler import RecordEvent
from ..scope import global_scope

__all__ = [
    "save_sharded", "load_sharded", "ShardedCheckpointManager",
    "TrainState", "TrainStateCheckpointManager", "CheckpointCorruptError",
    "CheckpointMismatchError", "capture_train_state", "apply_train_state",
    "save_train_state", "load_train_state", "save_train_state_sharded",
    "write_train_state_shards", "commit_sharded_train_state",
    "partition_shards", "sparse_table_state_vars", "row_delta",
]

TRAIN_STATE_FORMAT = 1

_ARRAYS_FILE = "arrays.npz"
_HOST_FILE = "train_state.json"
_MANIFEST_FILE = "MANIFEST.json"
_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp."
_DELTA_ROWS_SUFFIX = "@DELTA_ROWS"
_DELTA_VALUES_SUFFIX = "@DELTA_VALUES"
_SHARD_FILE = "shard_%05d.npz"
_SHARD_META = "shard_%05d.json"
_SHARED_TMP_SUFFIX = ".shared"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint artifact failed its manifest or checksum check."""


class CheckpointMismatchError(CheckpointCorruptError):
    """The artifact is intact but does not fit: another set of variables,
    another shape or other executor names.  Distinct from corruption so
    that ``restore`` stops with a configuration error instead of falling
    back past every older (equally misfitting) artifact to a fresh
    start."""


def _persistable_state(scope, program=None):
    """{name: scope value} of the program's persistable variables that the
    scope holds."""
    from ..framework import default_main_program

    program = program or default_main_program()
    state = {}
    for var in program.global_block().vars.values():
        if getattr(var, "persistable", False) and scope.has_var(var.name):
            state[var.name] = scope.var(var.name)
    return state


def _require_state(state, action):
    if not state:
        raise ValueError(
            "no persistable state in scope to %s: run the startup program "
            "first so the var set and shapes/dtypes exist" % action)


def _host_copy(v):
    """A private CPU tensor holding ``v``'s value: a copy even of a CPU
    tensor, which the next step updates in place, and a blocking copy of
    a card tensor, ordered after the step that wrote it."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(v, copy=True))


def _npz_encode(t):
    """(a numpy array npz can hold, the logical dtype name or None):
    bfloat16 and the float8 types go as same-width unsigned integers."""
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t), None
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16 or str(t.dtype).startswith("torch.float8"):
        signed = {1: torch.int8, 2: torch.int16}[t.element_size()]
        raw = t.view(signed).numpy()
        return raw.view("u%d" % t.element_size()), str(t.dtype)[6:]
    return t.numpy(), None


def _npz_decode(arr, dtype_name):
    """The tensor of a stored array (``_npz_encode``'s inverse; the JAX
    package's ``ml_dtypes`` names are torch's)."""
    arr = np.ascontiguousarray(arr)
    if not dtype_name:
        return torch.from_numpy(arr)
    dtype = getattr(torch, dtype_name, None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointCorruptError("unknown stored dtype %r" % dtype_name)
    signed = np.dtype("i%d" % arr.dtype.itemsize)
    return torch.from_numpy(arr.view(signed)).view(dtype)


def _named(objs, what):
    """The executors= / readers= argument as a dict: None, one object, a
    sequence (named by position) or a {name: obj} dict."""
    if objs is None:
        return {}
    if isinstance(objs, dict):
        return dict(objs)
    if isinstance(objs, (list, tuple)):
        return {"%s%d" % (what, i): o for i, o in enumerate(objs)}
    return {what + "0": objs}


def sparse_table_state_vars(program, names):
    """{var name: table height} of the state an incremental checkpoint
    delta-encodes for ``program``: every ``is_sparse`` lookup table and its
    row-wise optimizer slots (``<table>_moment1_0``...; the height check
    against the live values is applied at save time).  These are the vars
    the lazy SelectedRows update keeps bit-stable on untouched rows."""
    from ..ops.selected_rows import is_row_slot_of, sparse_lookup_tables

    tables = {w: int(v.shape[0])
              for w, v in sparse_lookup_tables(program).items()}
    out = {}
    for n in names:
        for t, h in tables.items():
            if n == t or is_row_slot_of(n, t):
                out[n] = h
                break
    return out


def _rows_bytes(t):
    """``t`` as [rows, bytes a row] uint8 (a view where it can be)."""
    t = t.contiguous()
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def row_delta(base, new):
    """(rows int64[K], values[K, ...]) of the dim-0 slices of ``new`` that
    differ from ``base``, compared bit for bit: a NaN row that kept its
    bits is not written, a row that moved by one ulp is, so base + delta
    replays bit-identically."""
    if tuple(base.shape) != tuple(new.shape) or base.dtype != new.dtype:
        raise ValueError("row_delta needs same-shape/dtype arrays, got "
                         "%s/%s vs %s/%s" % (tuple(base.shape), base.dtype,
                                             tuple(new.shape), new.dtype))
    diff = (_rows_bytes(new) != _rows_bytes(base)).any(dim=1)
    rows = torch.nonzero(diff).flatten().to(torch.int64)
    return rows, new[rows].contiguous()


def _apply_delta_ops(target, ops):
    """Apply one var's delta ops onto a private, mutable tensor: ``rows``
    (global row ids and their values) and ``range`` (a whole block at its
    global ``[[start, stop], ...]`` index, a sharded writer's full entry
    in a delta artifact)."""
    for op in ops:
        kind, sel, data = op[0], op[1], op[2]
        if kind == "rows":
            rows = torch.as_tensor(sel, dtype=torch.int64)
            target[rows] = data.reshape((len(rows),)
                                        + tuple(target.shape[1:]))
        elif kind == "range":
            view = target[tuple(slice(int(a), int(b)) for a, b in sel)]
            view[...] = data.reshape(view.shape)
        else:
            raise CheckpointCorruptError("unknown delta op kind %r" % kind)
    return target


class TrainState:
    """One snapshot at a step boundary: ``arrays`` ({name: CPU tensor})
    and ``host`` (JSON-able: step, executor and reader states, caller
    extras).

    A sharded capture (``capture_train_state(..., sharded=True)``) carries
    ``shards`` instead of ``arrays``: the entries this rank owns
    (``[{"name", "index", "data"}]``, ``index`` the global ``[[start,
    stop], ...]``), and ``array_meta``, the global shape and dtype of every
    var, which the elected saver writes into the artifact.  A loaded
    artifact always comes back with full ``arrays`` (the loader assembles
    the shards), so ``apply_train_state`` and the guardian's scan see one
    representation.

    An incremental artifact read straight off disk also carries ``delta``
    ({name: [("rows", rows, values) | ("range", index, values)]}) and is
    not self-contained: the manager's ``load`` replays its chain."""

    def __init__(self, step, arrays, host, shards=None, array_meta=None,
                 delta=None):
        self.step = int(step)
        self.arrays = arrays
        self.host = host
        self.shards = shards
        self.array_meta = array_meta
        self.delta = delta

    def __repr__(self):
        if self.arrays is None:
            return "TrainState(step=%d, shards=%d of %d vars, executors=%s)" \
                % (self.step, len(self.shards or ()),
                   len(self.array_meta or ()),
                   sorted(self.host.get("executors", {})))
        return "TrainState(step=%d, arrays=%d, executors=%s, readers=%s)" % (
            self.step, len(self.arrays),
            sorted(self.host.get("executors", {})),
            sorted(self.host.get("readers", {})))


def _dtype_name(v):
    """The numpy-style name of a value's dtype (``float32``, ``bfloat16``:
    torch's names are ``ml_dtypes``')."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype)[len("torch."):]
    return np.asarray(v).dtype.name


def _dtype_from_name(name):
    """The torch dtype of a stored dtype name (``_dtype_name``'s
    inverse)."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointCorruptError("unknown stored dtype %r" % name)
    return dtype


def _array_meta(state, shapes):
    """Global ``{name: {"shape", "dtype"}}`` of every state value: the
    same on every rank, so the elected saver's copy is the artifact's."""
    return {n: {"shape": [int(d) for d in shapes[n]],
                "dtype": _dtype_name(v)} for n, v in state.items()}


def _owned_shards(state, program):
    """(entries, global shapes) of ``state`` without a ``ParallelExecutor``:
    every value is whole and identical on every rank, and rank 0 owns it.
    In a world, a value held at another shape than its program var's is
    some executor's shard, which only that executor can place."""
    from ..framework import default_main_program
    from . import distributed

    program = program or default_main_program()
    block = program.global_block()
    world = distributed.process_count()
    entries, shapes = [], {}
    for n in sorted(state):
        shape = tuple(int(d) for d in np.shape(state[n]))
        var = block._find_var_recursive(n)
        declared = None if var is None or var.shape is None \
            else tuple(var.shape)
        if world > 1 and declared is not None \
                and all(d is not None and d >= 0 for d in declared) \
                and tuple(int(d) for d in declared) != shape:
            raise ValueError(
                "var %r is held at shape %s, not its global %s: a "
                "ParallelExecutor's shard; pass that executor in "
                "executors= so each rank writes the block it owns"
                % (n, shape, declared))
        shapes[n] = shape
        if distributed.process_id() == 0:
            entries.append({"name": n, "index": [[0, d] for d in shape],
                            "data": _host_copy(state[n])})
    return entries, shapes


def capture_train_state(step, scope=None, program=None, executors=None,
                        readers=None, extra=None, sharded=False):
    """Snapshot the train state at a step boundary.  Blocks only for the
    device-to-host copy of the persistable vars; whoever writes the
    snapshot serializes it (on the async path, under the next steps).
    ``executors`` / ``readers`` expose ``state_dict()``; the restoring side
    passes the same names.

    ``sharded=False``: full arrays (a ``ParallelExecutor``'s split vars
    gathered whole, a collective).  ``sharded=True``: only the blocks this
    rank owns, copied out with no collective (the per-rank path; write it
    with ``save_train_state_sharded`` or the manager's sharded mode)."""
    with RecordEvent("checkpoint/snapshot"):
        scope = scope or global_scope()
        state = _persistable_state(scope, program)
        _require_state(state, "snapshot")
        named = _named(executors, "executor")
        if sharded:
            shards, shapes = _shards_of(state, program, named.values())
        else:
            for e in named.values():
                gather = getattr(e, "gathered_state", None)
                if gather is not None:
                    state = gather(state, program)
        host = {
            "format": TRAIN_STATE_FORMAT,
            "step": int(step),
            "time": time.time(),
            "executors": {n: dict(e.state_dict())
                          for n, e in named.items()},
            "readers": {n: dict(r.state_dict())
                        for n, r in _named(readers, "reader").items()},
            "extra": dict(extra or {}),
        }
        if sharded:
            return TrainState(step, None, host, shards=shards,
                              array_meta=_array_meta(state, shapes))
        arrays = {n: _host_copy(v) for n, v in state.items()}
    return TrainState(step, arrays, host)


def _shards_of(state, program, executors):
    """(the entries this rank owns, every var's global shape): through the
    first executor that places vars on a mesh (``owned_shards``), else
    whole values owned by rank 0."""
    for e in executors:
        owned = getattr(e, "owned_shards", None)
        if owned is not None:
            return owned(state, program)
    return _owned_shards(state, program)


def apply_train_state(ts, scope=None, program=None, executors=None,
                      readers=None, shardings=None, strict=True):
    """Apply a restored ``TrainState``: each array into the scope, on the
    device and in the dtype of the value it replaces (a captured executor
    entry copies it into its graph's buffers at its next replay, and keeps
    its graph); executor states into the executors, positions into the
    readers.  ``strict`` requires every persistable var of the current
    program in the artifact, at its shape (or, with ``shardings``, the
    scope's value at its shard's).  ``shardings`` ({name: ``Sharding``},
    ``ParallelExecutor.state_shardings()``) puts the rank's shard of each
    array in the scope.  Returns the step."""
    shardings = shardings or {}
    scope = scope or global_scope()
    current = _persistable_state(scope, program)
    _require_state(current, "restore into")
    missing = sorted(set(current) - set(ts.arrays))
    if missing and strict:
        raise CheckpointMismatchError(
            "checkpoint (step %d) lacks persistable vars %s of the current "
            "program — not the same model (strict=False to restore the "
            "intersection)" % (ts.step, missing))
    if strict:
        for name, got in current.items():
            if name not in ts.arrays:
                continue
            want = ts.arrays[name]
            shapes = {tuple(want.shape)}
            if name in shardings:
                shapes.add(shardings[name].local_shape(tuple(want.shape)))
            if tuple(np.shape(got)) not in shapes:
                raise CheckpointMismatchError(
                    "checkpoint (step %d) var %r has shape %s but the "
                    "current model declares %s — not the same model"
                    % (ts.step, name, tuple(want.shape),
                       tuple(np.shape(got))))
    # the executor names are checked before the scope is touched: a
    # rejected checkpoint must not leave its params half-applied
    named_ex = _named(executors, "executor")
    if strict and ts.host.get("executors"):
        for name in named_ex:
            if name not in ts.host["executors"]:
                raise CheckpointMismatchError(
                    "checkpoint has no executor state named %r (saved: %s)"
                    % (name, sorted(ts.host["executors"])))
    for name, cur in current.items():
        if name not in ts.arrays:
            continue
        val = _as_tensor(ts.arrays[name])
        if name in shardings:
            val = shardings[name].shard(val)
        if isinstance(cur, torch.Tensor):
            val = val.to(device=cur.device, dtype=cur.dtype, copy=True)
        scope.set_var(name, val)
    for name, ex in named_ex.items():
        st = ts.host.get("executors", {}).get(name)
        if st is not None:
            ex.load_state_dict(st)
    for name, r in _named(readers, "reader").items():
        st = ts.host.get("readers", {}).get(name)
        if st is not None:
            r.load_state_dict(st)
    return ts.step


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_dir(path):
    """Flush a directory entry: a rename is durable once the directory
    that holds it is synced."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:       # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_synced(path, write):
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_train_state(dirname, ts):
    """Write ``ts`` as one atomic artifact (``arrays.npz``,
    ``train_state.json``, ``MANIFEST.json``) assembled in a ``.tmp.``
    sibling and committed with one directory rename."""
    if ts.arrays is None:
        raise ValueError(
            "this TrainState was captured sharded (shards, not full "
            "arrays): write it with save_train_state_sharded")
    dirname = os.path.abspath(dirname)
    parent = os.path.dirname(dirname)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, _TMP_PREFIX + "%s.%d"
                       % (os.path.basename(dirname), os.getpid()))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        fault.fire("checkpoint/before_write", ts.step)
        to_encode = dict(ts.arrays)
        for n, ops in (ts.delta or {}).items():
            (kind, rows, values), = ops
            if kind != "rows":
                raise ValueError("save_train_state encodes one rows-op "
                                 "delta a var; %r carries %r" % (n, kind))
            to_encode[n + _DELTA_ROWS_SUFFIX] = _as_tensor(rows).to(
                torch.int64)
            to_encode[n + _DELTA_VALUES_SUFFIX] = values
        encoded, raw_dtypes = {}, {}
        for n, a in to_encode.items():
            encoded[n], logical = _npz_encode(a)
            if logical:
                raw_dtypes[n] = logical
        host = dict(ts.host)
        host["raw_dtypes"] = raw_dtypes
        # positional members and an ordered name list: npz member names
        # cannot carry '/' and the like across numpy versions
        names = sorted(encoded)
        arrays_path = os.path.join(tmp, _ARRAYS_FILE)
        _write_synced(arrays_path, lambda f: np.savez(
            f, **{"arr_%d" % i: encoded[n] for i, n in enumerate(names)}))
        host["array_names"] = names
        host_path = os.path.join(tmp, _HOST_FILE)
        _write_synced(host_path, lambda f: f.write(
            json.dumps(host).encode()))
        fault.fire("checkpoint/after_write", ts.step)
        manifest = {
            "format": TRAIN_STATE_FORMAT,
            "step": ts.step,
            "files": {
                _ARRAYS_FILE: {"sha256": _sha256(arrays_path),
                               "bytes": os.path.getsize(arrays_path)},
                _HOST_FILE: {"sha256": _sha256(host_path),
                             "bytes": os.path.getsize(host_path)},
            },
        }
        if ts.host.get("incremental"):
            # the chain pointers in the manifest too: rotation walks
            # chains without opening (and hashing) the payloads
            manifest["incremental"] = {
                k: ts.host["incremental"][k]
                for k in ("base_step", "prev_step")}
        _write_synced(os.path.join(tmp, _MANIFEST_FILE), lambda f: f.write(
            json.dumps(manifest).encode()))
        fault.fire("checkpoint/before_commit", ts.step)
        _commit_artifact_dir(dirname, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dirname


def _commit_artifact_dir(dirname, tmp):
    """The commit point.  Re-saving a step renames the old artifact aside
    first (a ``.tmp.`` sibling the next manager reclaims), so no window
    holds a half-deleted artifact."""
    parent = os.path.dirname(dirname)
    if os.path.isdir(dirname):
        old = tmp + ".replaced"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(dirname, old)
        os.replace(tmp, dirname)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, dirname)
    _fsync_dir(parent or ".")


def load_train_state(dirname):
    """Read and check one artifact, full or sharded (a sharded one is
    assembled into full arrays); ``CheckpointCorruptError`` on a missing,
    partial or garbled one (no manifest, a checksum mismatch, an
    undecodable payload, a shard set that does not cover a var)."""
    dirname = os.path.abspath(dirname)
    try:
        with open(os.path.join(dirname, _MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            "checkpoint %s: unreadable manifest (%s) — likely a partial "
            "write" % (dirname, e))
    try:
        for fname, meta in manifest["files"].items():
            fpath = os.path.join(dirname, fname)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    "checkpoint %s: missing %s" % (dirname, fname))
            if _sha256(fpath) != meta["sha256"]:
                raise CheckpointCorruptError(
                    "checkpoint %s: %s fails its sha256 — corrupt"
                    % (dirname, fname))
        if manifest.get("sharded"):
            return _load_sharded_train_state(dirname, manifest)
        with open(os.path.join(dirname, _HOST_FILE)) as f:
            host = json.load(f)
        raw_dtypes = host.pop("raw_dtypes", {})
        names = host.pop("array_names")
        with np.load(os.path.join(dirname, _ARRAYS_FILE)) as z:
            arrays = {n: _npz_decode(z["arr_%d" % i], raw_dtypes.get(n))
                      for i, n in enumerate(names)}
        delta = None
        if host.get("incremental"):
            delta = {}
            for n in host["incremental"].get("delta_vars", []):
                rows = arrays.pop(n + _DELTA_ROWS_SUFFIX)
                values = arrays.pop(n + _DELTA_VALUES_SUFFIX)
                delta[n] = [("rows", rows, values)]
        return TrainState(manifest["step"], arrays, host, delta=delta)
    except CheckpointCorruptError:
        raise
    except Exception as e:  # noqa: BLE001 — any decode failure is corrupt
        raise CheckpointCorruptError(
            "checkpoint %s: undecodable (%r)" % (dirname, e))


# -- the sharded artifact: one file of owned blocks a writer ---------------

def partition_shards(ts, writers):
    """Split a sharded TrainState's entries over ``writers`` virtual
    writers (one process standing in for N, as the card run and the
    tests do): an entry whose dim 0 holds at least ``writers`` rows is cut
    along it (close to 1/N of the bytes for the tensors that dominate the
    state), the rest go round-robin whole.  Returns ``writers`` entry
    lists.  A real world never calls this: ownership is the partition."""
    writers = max(1, int(writers))
    out = [[] for _ in range(writers)]
    rr = 0
    for e in ts.shards:
        data = _as_tensor(e["data"])
        if data.dim() >= 1 and data.shape[0] >= writers:
            start, off = int(e["index"][0][0]), 0
            for w, piece in enumerate(torch.tensor_split(data, writers)):
                idx = [list(r) for r in e["index"]]
                idx[0] = [start + off, start + off + int(piece.shape[0])]
                off += int(piece.shape[0])
                out[w].append({"name": e["name"], "index": idx,
                               "data": piece})
        else:
            out[rr % writers].append(e)
            rr += 1
    return out


def _sharded_tmp(dirname):
    """The shared tmp directory every writer of one artifact assembles
    into: a name all writers agree on, unlike the full path's
    pid-suffixed one."""
    dirname = os.path.abspath(dirname)
    return os.path.join(os.path.dirname(dirname),
                        _TMP_PREFIX + os.path.basename(dirname)
                        + _SHARED_TMP_SUFFIX)


def write_train_state_shards(dirname, ts, writer_id, entries=None):
    """Write one writer's shard file and sidecar into the artifact's
    shared tmp directory.  ``entries`` defaults to the TrainState's own
    (a ``partition_shards`` slice for a virtual writer).  The sidecar
    lands last, by rename: it is what the committing saver polls for.
    Returns the bytes written."""
    if ts.shards is None:
        raise ValueError("TrainState was not captured sharded "
                         "(capture_train_state(..., sharded=True))")
    entries = ts.shards if entries is None else entries
    writer_id = int(writer_id)
    tmp = _sharded_tmp(dirname)
    os.makedirs(tmp, exist_ok=True)
    fault.fire("checkpoint/before_write", ts.step)
    members = {}
    for i, e in enumerate(entries):
        members["arr_%d" % i] = _npz_encode(_as_tensor(e["data"]))[0]
        if e.get("rows") is not None:
            # a delta entry: the writer's changed rows, as global ids
            members["rows_%d" % i] = _npz_encode(
                _as_tensor(e["rows"]).to(torch.int64))[0]
    npz_path = os.path.join(tmp, _SHARD_FILE % writer_id)
    _write_synced(npz_path, lambda f: np.savez(f, **members))
    sidecar = {
        "writer": writer_id,
        "step": ts.step,
        "entries": [dict({"name": e["name"], "index": e["index"]},
                         **({"delta": True} if e.get("rows") is not None
                            else {}))
                    for e in entries],
        "bytes": os.path.getsize(npz_path),
        "sha256": _sha256(npz_path),
    }
    side_path = os.path.join(tmp, _SHARD_META % writer_id)
    _write_synced(side_path + ".part",
                  lambda f: f.write(json.dumps(sidecar).encode()))
    os.replace(side_path + ".part", side_path)
    _fsync_dir(tmp)
    fault.fire("checkpoint/after_write", ts.step)
    return sidecar["bytes"]


def commit_sharded_train_state(dirname, ts, expected_writers, timeout=120.0,
                               poll=0.05):
    """The elected saver's half: wait until every expected writer's
    sidecar is in the shared tmp directory, then write
    ``train_state.json`` and the manifest and commit with one rename.
    ``CheckpointCorruptError`` when a writer has not delivered within
    ``timeout`` (the tmp directory stays for a later manager to reclaim;
    restores never see it)."""
    dirname = os.path.abspath(dirname)
    tmp = _sharded_tmp(dirname)
    expected = list(range(int(expected_writers)))
    deadline = time.monotonic() + float(timeout)
    while True:
        missing = [w for w in expected
                   if not os.path.exists(os.path.join(tmp, _SHARD_META % w))]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise CheckpointCorruptError(
                "sharded checkpoint step %d: writers %s never delivered "
                "their shards within %.0fs — commit abandoned"
                % (ts.step, missing, timeout))
        time.sleep(poll)
    try:
        host = dict(ts.host)
        meta = {}
        for n, m in (ts.array_meta or {}).items():
            entry = {"shape": list(m["shape"]), "dtype": m["dtype"]}
            raw, logical = _npz_encode(
                torch.empty(0, dtype=_dtype_from_name(m["dtype"])))
            if logical:
                entry["raw_dtype"] = raw.dtype.name
            meta[n] = entry
        host["array_meta"] = meta
        host_path = os.path.join(tmp, _HOST_FILE)
        _write_synced(host_path, lambda f: f.write(
            json.dumps(host).encode()))
        files = {_HOST_FILE: {"sha256": _sha256(host_path),
                              "bytes": os.path.getsize(host_path)}}
        per_writer = {}
        for w in expected:
            # each writer hashed its own shard file into its sidecar; the
            # saver hashes the sidecars only (manifest -> sidecar ->
            # payload), or the commit would read the whole state
            side_path = os.path.join(tmp, _SHARD_META % w)
            with open(side_path) as f:
                side = json.load(f)
            if not ts.host.get("incremental") and \
                    any(e.get("delta") for e in side["entries"]):
                # a peer wrote row deltas while this saver encoded a full
                # artifact: a mixed artifact no loader can read, and a
                # broken base for later deltas
                raise CheckpointCorruptError(
                    "sharded checkpoint step %d: writer %d delivered delta "
                    "entries but the committing saver encoded a full "
                    "artifact — incremental cadence desynchronized across "
                    "hosts; commit refused" % (ts.step, w))
            files[_SHARD_FILE % w] = {"sha256": side["sha256"],
                                      "bytes": side["bytes"]}
            files[_SHARD_META % w] = {"sha256": _sha256(side_path),
                                      "bytes": os.path.getsize(side_path)}
            per_writer[str(w)] = side["bytes"]
        manifest = {
            "format": TRAIN_STATE_FORMAT,
            "sharded": True,
            "step": ts.step,
            "writers": len(expected),
            "per_writer_bytes": per_writer,
            "files": files,
        }
        if ts.host.get("incremental"):
            manifest["incremental"] = {
                k: ts.host["incremental"][k]
                for k in ("base_step", "prev_step")}
        _write_synced(os.path.join(tmp, _MANIFEST_FILE), lambda f: f.write(
            json.dumps(manifest).encode()))
        fault.fire("checkpoint/before_commit", ts.step)
        _commit_artifact_dir(dirname, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dirname


def save_train_state_sharded(dirname, ts, writer_id=0, writers=1,
                             saver=True, commit_timeout=120.0):
    """One writer's leg of a sharded save: its shards, then, on the
    elected ``saver``, the wait for the peers and the commit.  Returns the
    committed dirname (saver) or the bytes this writer wrote."""
    written = write_train_state_shards(dirname, ts, writer_id)
    if not saver:
        return written
    return commit_sharded_train_state(dirname, ts, writers,
                                      timeout=commit_timeout)


def _load_sharded_train_state(dirname, manifest):
    """Assemble a sharded artifact (its files' sha256 already checked) into
    full arrays: each var a buffer filled from its entries, an
    incompletely covered var corrupt, never a silently partial restore.
    In an incremental artifact a var with delta entries comes back as
    ops instead (a writer's full block as ``range``, its changed rows as
    ``rows``), which the manager's chain replay applies onto the base."""
    with open(os.path.join(dirname, _HOST_FILE)) as f:
        host = json.load(f)
    meta = host.pop("array_meta")
    incremental = bool(host.get("incremental"))
    entries = {n: [] for n in meta}     # name -> [(index, rows, data)]
    for w in range(int(manifest["writers"])):
        with open(os.path.join(dirname, _SHARD_META % w)) as f:
            sidecar = json.load(f)
        with np.load(os.path.join(dirname, _SHARD_FILE % w)) as z:
            for i, e in enumerate(sidecar["entries"]):
                m = meta[e["name"]]
                data = _npz_decode(z["arr_%d" % i],
                                   m["dtype"] if m.get("raw_dtype") else None)
                rows = torch.from_numpy(z["rows_%d" % i]) \
                    if e.get("delta") else None
                entries[e["name"]].append((e["index"], rows, data))
    buffers, delta = {}, {}
    for n, m in meta.items():
        total = int(np.prod(m["shape"], dtype=np.int64))
        full = [(idx, data) for idx, rows, data in entries[n]
                if rows is None]
        covered = sum(int(data.numel()) for _, data in full)
        if covered == total and len(full) == len(entries[n]):
            buf = torch.empty(tuple(m["shape"]),
                              dtype=_dtype_from_name(m["dtype"]))
            for idx, data in full:
                view = buf[tuple(slice(a, b) for a, b in idx)]
                view[...] = data.reshape(view.shape)
            buffers[n] = buf
            continue
        if not incremental:
            raise CheckpointCorruptError(
                "sharded checkpoint %s: var %r covered %d of %d elements — "
                "shard set incomplete" % (dirname, n, covered, total))
        # delta entries carry changed rows, not their block: coverage is
        # counted over the index extents, every writer still owing an
        # entry for its block
        idx_cov = sum(int(np.prod([b - a for a, b in idx], dtype=np.int64))
                      for idx, _, _ in entries[n])
        if idx_cov != total:
            raise CheckpointCorruptError(
                "sharded checkpoint %s: var %r shard index coverage %d of "
                "%d elements — shard set incomplete"
                % (dirname, n, idx_cov, total))
        delta[n] = [("range", idx, data) for idx, data in full] + \
            [("rows", rows, data) for _, rows, data in entries[n]
             if rows is not None]
    return TrainState(manifest["step"], buffers, host, delta=delta or None)


def _nbytes(t):
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else np.asarray(t).nbytes


class TrainStateCheckpointManager:
    """Step-indexed TrainState checkpoints under ``dirname``: saves gated
    every ``save_interval_steps`` steps, written asynchronously
    (``async_save``) or in the caller's thread, ``max_to_keep`` kept, and a
    restore that falls back past corrupt artifacts.  ``incremental``
    (``True``/``'auto'``: every ``is_sparse`` table and its row slots, or
    a list of var names) writes those vars as row deltas against the
    previous artifact, a full base every ``incremental_full_every``
    artifacts.

    Sharded mode (``sharded=True``, or the default ``None``: sharded
    exactly when the world holds more than one process): each rank
    captures and writes only the blocks it owns, and the writer elected
    by ``saver_elect(step)`` (default writer 0) waits for its peers'
    sidecars and commits; non-savers never rotate.  A writer's id and the
    writer count are the world's rank and size.  Restores read either
    format on any world size.  In incremental mode each writer
    diffs only its own blocks."""

    def __init__(self, dirname, max_to_keep=3, save_interval_steps=1,
                 async_save=True, sharded=None, saver_elect=None,
                 commit_timeout=120.0, incremental=None,
                 incremental_full_every=8):
        self._dir = os.path.abspath(dirname)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max(1, int(max_to_keep)) \
            if max_to_keep is not None else None
        self._interval = max(1, int(save_interval_steps))
        self._async = bool(async_save)
        self._sharded = sharded
        self._saver_elect = saver_elect
        self._commit_timeout = float(commit_timeout)
        self._last_saved = None
        # the last step whose write finished on this rank: committed, or
        # (a sharded non-saver) its shards delivered to the saver
        self._last_written = None
        self._inflight = None            # (thread, step)
        self._error = None
        self._incremental = incremental
        self._full_every = max(1, int(incremental_full_every))
        self._incr_base = {}         # {name: tensor} of the last artifact
        self._incr_shard_base = {}   # sharded: {(name, index): tensor}
        self._incr_full_base = {}    # restored full arrays, sliced lazily
        #                              into shard bases
        self._incr_base_step = None  # step of the generation's full base
        self._incr_prev_step = None  # step of the last written artifact
        self._deltas_since_full = 0
        # the measured costs of the latest saves: the snapshot on the
        # caller's thread and the write
        self._snapshot_s = collections.deque(maxlen=16)
        self._save_s = collections.deque(maxlen=16)
        self._mu = threading.Lock()
        self.last_restored = None        # TrainState of the last restore
        # a dead process's .tmp. dirs (a kill mid-save) are garbage; a
        # shared sharded tmp may be a live peer's write in flight, so it
        # goes only once older than the commit timeout, which nothing
        # waits past
        now = time.time()
        for entry in os.listdir(self._dir):
            if not entry.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self._dir, entry)
            if entry.endswith(_SHARED_TMP_SUFFIX):
                try:
                    age = now - os.path.getmtime(path)
                except OSError:
                    continue
                if age <= self._commit_timeout:
                    continue
            shutil.rmtree(path, ignore_errors=True)

    # -- paths / listing ----------------------------------------------
    def _step_dir(self, step):
        return os.path.join(self._dir, "%s%010d" % (_STEP_PREFIX, step))

    def all_steps(self):
        """Committed step indices, ascending (nothing is checked)."""
        out = []
        for entry in os.listdir(self._dir):
            if entry.startswith(_STEP_PREFIX):
                try:
                    out.append(int(entry[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step):
        last = self._last_saved
        if last is None:
            last = self.latest_step()
        return last is None or step >= last + self._interval

    @property
    def save_interval_steps(self):
        return self._interval

    def set_interval(self, steps):
        """Change the save cadence (a tuned ``checkpoint_interval``)."""
        self._interval = max(1, int(steps))

    def measured_costs(self):
        """Mean seconds of this manager's snapshots and writes, and the
        sample count; {} before the first save."""
        snaps, saves = list(self._snapshot_s), list(self._save_s)
        out = {}
        if snaps:
            out["snapshot_s"] = sum(snaps) / len(snaps)
        if saves:
            out["save_s"] = sum(saves) / len(saves)
        if out:
            out["n"] = max(len(snaps), len(saves))
        return out

    # -- sharded-mode identity -----------------------------------------
    def sharded_mode(self):
        """Whether saves take the sharded path: ``sharded=`` when given,
        else whether the world holds more than one process."""
        from . import distributed

        if self._sharded is not None:
            return bool(self._sharded)
        return distributed.process_count() > 1

    @staticmethod
    def _writer_identity():
        from . import distributed

        return distributed.process_id(), distributed.process_count()

    def _is_saver(self, step):
        """The one committer of a sharded artifact: ``saver_elect(step)``
        when given, else writer 0."""
        if self._saver_elect is not None:
            return bool(self._saver_elect(step))
        return self._writer_identity()[0] == 0

    # -- incremental (delta) encoding ----------------------------------
    def _resolve_incr_names(self, program, ts):
        """{var name: table height or None} this artifact may
        delta-encode (resolved on the save path: 'auto' needs the
        program)."""
        if not self._incremental:
            return None
        names = set(ts.arrays if ts.arrays is not None
                    else ts.array_meta or ())
        if self._incremental in (True, "auto"):
            from ..framework import default_main_program

            return sparse_table_state_vars(
                program if program is not None else default_main_program(),
                names)
        return {n: None for n in self._incremental if n in names}

    @staticmethod
    def _delta_eligible(t, height):
        if t.dim() < 1 or t.numel() == 0:
            return False
        return height is None or t.shape[0] == int(height)

    def _encode_incremental(self, ts, names):
        """Rewrite ``ts`` in place into a delta artifact when a base exists
        and the generation is not due for a full one; the base becomes
        this artifact's values either way, so the next diff is against
        the last written state."""
        if not names:
            return
        if ts.shards is not None:
            return self._encode_incremental_shards(ts, names)
        eligible = {n: ts.arrays[n] for n, h in names.items()
                    if n in ts.arrays
                    and self._delta_eligible(ts.arrays[n], h)}
        want_full = (self._incr_prev_step is None
                     or self._deltas_since_full >= self._full_every - 1
                     or not eligible)
        if not want_full:
            delta, rows_count = {}, {}
            for n, a in eligible.items():
                base = self._incr_base.get(n)
                if base is None or base.shape != a.shape \
                        or base.dtype != a.dtype:
                    continue        # ships full in this artifact
                rows, values = row_delta(base, a)
                delta[n] = [("rows", rows, values)]
                rows_count[n] = int(rows.shape[0])
            if delta:
                for n in delta:
                    del ts.arrays[n]
                ts.delta = delta
                ts.host["incremental"] = {
                    "base_step": self._incr_base_step,
                    "prev_step": self._incr_prev_step,
                    "delta_vars": sorted(delta),
                    "delta_rows": rows_count,
                }
                self._deltas_since_full += 1
            else:
                want_full = True
        if want_full:
            self._incr_base_step = ts.step
            self._deltas_since_full = 0
        self._incr_base = dict(eligible)     # the capture's private copies
        self._incr_prev_step = ts.step

    def _encode_incremental_shards(self, ts, names):
        """The sharded leg: each writer diffs only its own entries against
        its shard base and writes their changed rows, as global row ids.
        An entry without a base (a fresh writer, a resized block) ships
        whole; the loader folds mixed full and delta entries."""
        want_full = (self._incr_prev_step is None
                     or self._deltas_since_full >= self._full_every - 1)
        new_entries, delta_vars, rows_count, new_base = [], set(), {}, {}
        for e in ts.shards:
            n, a = e["name"], _as_tensor(e["data"])
            # a block's dim 0 is a slice of the table's: membership and a
            # non-scalar make it eligible, not the height
            track = n in names and a.dim() >= 1 and a.numel() > 0
            key = (n, tuple(tuple(int(x) for x in r) for r in e["index"]))
            base = self._incr_shard_base.get(key)
            if base is None and n in self._incr_full_base:
                cand = self._incr_full_base[n][
                    tuple(slice(x, y) for x, y in e["index"])]
                if tuple(cand.shape) == tuple(a.shape):
                    base = cand.contiguous()
            if track:
                new_base[key] = a
            if want_full or not track or base is None \
                    or tuple(base.shape) != tuple(a.shape) \
                    or base.dtype != a.dtype:
                new_entries.append(e)
                continue
            rows, values = row_delta(base, a)
            new_entries.append({"name": n, "index": e["index"],
                                "rows": rows + int(e["index"][0][0]),
                                "data": values})
            delta_vars.add(n)
            rows_count[n] = rows_count.get(n, 0) + int(rows.shape[0])
        self._incr_shard_base = new_base
        self._incr_full_base = {}
        ts.shards = new_entries
        if delta_vars:
            ts.host["incremental"] = {
                "base_step": self._incr_base_step,
                "prev_step": self._incr_prev_step,
                "delta_vars": sorted(delta_vars),
                "delta_rows": rows_count,
            }
            self._deltas_since_full += 1
        else:
            self._incr_base_step = ts.step
            self._deltas_since_full = 0
        self._incr_prev_step = ts.step

    def _chain_prev(self, step):
        """An artifact's prev_step (from its manifest), or None for a full
        artifact or an unreadable manifest."""
        try:
            with open(os.path.join(self._step_dir(step),
                                   _MANIFEST_FILE)) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return None
        inc = m.get("incremental")
        return int(inc["prev_step"]) if inc else None

    def _seed_incremental_base(self, ts):
        """After a restore the restored arrays are the state at
        ``ts.step``: they seed the diff base, so the next save continues
        the delta chain."""
        if not self._incremental:
            return
        inc = ts.host.get("incremental")
        if not inc:
            self._incr_base_step = self._incr_prev_step = None
            self._deltas_since_full = 0
            self._incr_base, self._incr_shard_base = {}, {}
            self._incr_full_base = {}
            return
        self._incr_base = {n: ts.arrays[n].clone()
                           for n in inc.get("delta_vars", [])
                           if n in ts.arrays}
        self._incr_shard_base = {}
        self._incr_full_base = dict(self._incr_base)
        self._incr_base_step = int(inc["base_step"])
        self._incr_prev_step = int(ts.step)
        # restart the full cadence from here, conservatively
        self._deltas_since_full = 1

    # -- save ----------------------------------------------------------
    def _snapshot(self, step, scope, program, executors, readers, extra):
        t0 = time.perf_counter()
        ts = capture_train_state(step, scope=scope, program=program,
                                 executors=executors, readers=readers,
                                 extra=extra, sharded=self.sharded_mode())
        # resolved on the caller's thread (it reads the program); the diff
        # runs in the writer
        ts._incr_names = self._resolve_incr_names(program, ts)
        self._snapshot_s.append(time.perf_counter() - t0)
        self._last_saved = int(step)
        return ts

    def save(self, step, scope=None, program=None, executors=None,
             readers=None, extra=None):
        """Interval-gated save at ``step``: False when gated; True once the
        snapshot is taken and the write runs (committed, without
        ``async_save``)."""
        self._reraise()
        if not self.should_save(step):
            return False
        self.wait_until_finished()       # the previous write first
        ts = self._snapshot(step, scope, program, executors, readers, extra)
        if not self._async:
            self._write(ts)
            return True
        t = threading.Thread(target=self._write_guarded, args=(ts,),
                             name="ckpt-write-%d" % step, daemon=True)
        with self._mu:
            self._inflight = (t, int(step))
        t.start()
        return True

    def save_now(self, step, scope=None, program=None, executors=None,
                 readers=None, extra=None):
        """A synchronous save past the interval gate (the preemption
        flush): joins an inflight write and returns once this rank's part
        is done (the artifact committed, or a non-saver's shards
        delivered).  A step this manager already wrote is not written
        again: a non-saver cannot see whether the saver has committed
        yet, and a second write would rewrite its shard file in the
        shared tmp directory the saver is renaming."""
        self._reraise()
        self.wait_until_finished()
        if self._last_written == int(step):
            return True
        self._write(self._snapshot(step, scope, program, executors, readers,
                                   extra))
        return True

    def _write_guarded(self, ts):
        try:
            self._write(ts)
        except BaseException as e:  # noqa: BLE001 — raised at the next call
            with self._mu:
                self._error = e

    def _write(self, ts):
        from . import distributed

        if ts.shards is None and distributed.process_id() != 0:
            self._last_written = ts.step
            return           # the full path's one writer: rank 0
        t0 = time.perf_counter()
        step_dir = self._step_dir(ts.step)
        # the diff runs here, in the writer, with the rest of the
        # serialization
        self._encode_incremental(ts, getattr(ts, "_incr_names", None))
        inc = ts.host.get("incremental")
        if ts.shards is not None:
            wid, writers = self._writer_identity()
            saver = self._is_saver(ts.step)
            nbytes = sum(_nbytes(e["data"]) for e in ts.shards)
            with RecordEvent("checkpoint/save"):
                save_train_state_sharded(
                    step_dir, ts, writer_id=wid, writers=writers,
                    saver=saver, commit_timeout=self._commit_timeout)
            extra = {"sharded": True, "writer_id": wid, "writers": writers,
                     "saver": saver}
        else:
            nbytes = sum(_nbytes(a) for a in ts.arrays.values())
            nbytes += sum(_nbytes(rows) + _nbytes(values)
                          for ops in (ts.delta or {}).values()
                          for _, rows, values in ops)
            with RecordEvent("checkpoint/save"):
                save_train_state(step_dir, ts)
            saver, extra = True, {}
        if inc:
            extra = dict(extra, incremental=True,
                         base_step=inc["base_step"],
                         delta_rows=inc.get("delta_rows"))
            monitor.count("checkpoint/incremental_saves")
            monitor.count("checkpoint/incremental_rows",
                          sum((inc.get("delta_rows") or {}).values()))
        self._save_s.append(time.perf_counter() - t0)
        self._last_written = ts.step
        if saver:
            # a non-saver never rotates: its deletes would race the
            # committer's rename
            self._rotate()
        monitor.mark("checkpoint/saved")
        monitor.log_event(dict({
            "event": "checkpoint_saved", "ts": time.time(),
            "step": ts.step, "path": step_dir,
            "seconds": round(time.perf_counter() - t0, 6),
            "bytes": nbytes, "async": self._async}, **extra))
        return step_dir

    def _rotate(self):
        if self._max_to_keep is None:
            return
        steps = self.all_steps()
        keep = set(steps[-self._max_to_keep:])
        # a kept delta artifact restores only through its chain: every
        # artifact back to its full base stays
        need = set()
        for s in keep:
            cur, guard = s, 0
            while cur is not None and cur not in need and guard < 65536:
                need.add(cur)
                cur = self._chain_prev(cur)
                guard += 1
        for s in steps:
            if s not in keep and s not in need:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _reraise(self):
        with self._mu:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "previous async checkpoint write failed") from err

    def wait_until_finished(self):
        with self._mu:
            inflight = self._inflight
        if inflight is not None:
            inflight[0].join()
            with self._mu:
                if self._inflight is inflight:
                    self._inflight = None
        self._reraise()

    # -- restore -------------------------------------------------------
    def load(self, step):
        """Read and check the artifact at ``step`` without applying it
        (the guardian rejects poisoned artifacts this way);
        ``CheckpointCorruptError`` on a corrupt or partial one.  An
        incremental artifact comes back with full arrays: its chain is
        replayed from the full base, delta by delta."""
        ts = load_train_state(self._step_dir(step))
        if not ts.host.get("incremental"):
            return ts
        chain, seen = [ts], {ts.step}
        cur = ts
        while cur.host.get("incremental"):
            prev = int(cur.host["incremental"]["prev_step"])
            if prev in seen:
                raise CheckpointCorruptError(
                    "incremental chain at step %d cycles through step %d"
                    % (step, prev))
            seen.add(prev)
            cur = load_train_state(self._step_dir(prev))
            chain.append(cur)
        arrays = dict(cur.arrays)      # the full base artifact
        for d in reversed(chain[:-1]):
            arrays.update(d.arrays or {})
            for n, ops in (d.delta or {}).items():
                if n not in arrays:
                    raise CheckpointCorruptError(
                        "incremental chain: delta var %r (step %d) has no "
                        "base value" % (n, d.step))
                # each loaded artifact's tensors are its own, so the
                # deltas apply in place
                arrays[n] = _apply_delta_ops(arrays[n], ops)
        return TrainState(step, arrays, dict(chain[0].host))

    def restore(self, scope=None, program=None, executors=None,
                readers=None, step=None, shardings=None, strict=True,
                train_state=None):
        """Restore ``step`` (default: the newest artifact that loads,
        falling back past corrupt or partial ones with a warning).
        Returns the step, or None when no usable artifact exists; the
        TrainState stays readable as ``last_restored``.  ``train_state``:
        the TrainState ``load(step)`` already read (requires ``step``)."""
        self.wait_until_finished()
        candidates = [step] if step is not None \
            else list(reversed(self.all_steps()))
        for s in candidates:
            try:
                ts = train_state if (train_state is not None
                                     and step is not None) \
                    else self.load(s)
                restored = apply_train_state(
                    ts, scope=scope, program=program, executors=executors,
                    readers=readers, shardings=shardings, strict=strict)
            except CheckpointMismatchError:
                # every older artifact shares a structural misfit: falling
                # back would end silently in a fresh start
                raise
            except CheckpointCorruptError as e:
                if step is not None:
                    raise
                warnings.warn(
                    "skipping corrupt checkpoint step %d (%s); falling back "
                    "to the previous one" % (s, e))
                monitor.mark("checkpoint/corrupt_skipped")
                continue
            self.last_restored = ts
            # the save cadence restarts from the restored step: replayed
            # steps checkpoint on schedule, and a skipped corrupt
            # artifact is overwritten at its step
            self._last_saved = self._last_written = restored
            self._seed_incremental_base(ts)
            monitor.log_event({"event": "checkpoint_restored",
                               "ts": time.time(), "step": restored})
            return restored
        return None

    def close(self):
        self.wait_until_finished()


# -- the orbax API over the sharded format ---------------------------------

def _agreed(action, dirname, leg):
    """Run this rank's ``leg`` of a collective sharded save, then take one
    vote over the world (``distributed.any_process_flagged``) on whether
    every rank's leg succeeded.  Every rank takes the same collective
    whatever its leg did, so a failure raises on every rank (a saver
    whose peer delivered nothing, after its commit timeout) and no rank
    is left in a collective its peers never reach; rank 0 then removes
    the shared tmp directory."""
    from . import distributed

    err = None
    try:
        leg()
    except Exception as e:  # noqa: BLE001 — raised below, after the vote
        err = e
    if distributed.any_process_flagged(err is not None):
        if distributed.process_id() == 0:
            shutil.rmtree(_sharded_tmp(dirname), ignore_errors=True)
        if err is not None:
            raise err
        raise CheckpointCorruptError(
            "%s: a peer rank failed its leg; no artifact at %s"
            % (action, dirname))


def save_sharded(dirname, scope=None, program=None, executors=None):
    """Write the persistable state as a sharded artifact at ``dirname``, a
    collective: each rank writes the blocks it owns (``executors``: the
    ``ParallelExecutor`` that holds vars split; without one every value is
    whole and rank 0 writes it), the world agrees every shard landed,
    rank 0 commits, and every rank returns once the artifact is
    committed.  Returns the var names."""
    from . import distributed

    scope = scope or global_scope()
    state = _persistable_state(scope, program)
    _require_state(state, "save")
    shards, shapes = _shards_of(state, program,
                                _named(executors, "executor").values())
    ts = TrainState(0, None, {"format": TRAIN_STATE_FORMAT, "step": 0},
                    shards=shards, array_meta=_array_meta(state, shapes))
    rank, world = distributed.process_id(), distributed.process_count()
    _agreed("save_sharded", dirname,
            lambda: write_train_state_shards(dirname, ts, rank))
    # every sidecar is in place: the commit waits for no one
    _agreed("save_sharded", dirname, lambda: rank == 0 and
            commit_sharded_train_state(dirname, ts, world))
    _require_committed("save_sharded", dirname)
    return sorted(state)


def _require_committed(action, dirname):
    if not os.path.exists(os.path.join(os.path.abspath(dirname),
                                       _MANIFEST_FILE)):
        raise CheckpointCorruptError(
            "%s: the saver committed no artifact at %s" % (action, dirname))


def load_sharded(dirname, scope=None, program=None, shardings=None):
    """Restore a sharded artifact (or a full one) into the scope.
    ``shardings`` ({name: ``Sharding``}, ``pe.state_shardings()``) puts
    each rank's block of the assembled arrays in the scope, on whatever
    mesh restores; without it the values are whole.  Returns the var
    names."""
    scope = scope or global_scope()
    state = _persistable_state(scope, program)
    _require_state(state, "restore into")
    ts = load_train_state(dirname)
    apply_train_state(ts, scope=scope, program=program, shardings=shardings)
    return sorted(set(state) & set(ts.arrays))


class ShardedCheckpointManager:
    """Step-indexed sharded checkpoints with ``max_to_keep`` rotation and
    interval-gated, asynchronous saves (the JAX package's orbax manager's
    API; a layer over ``TrainStateCheckpointManager(sharded=True)``).
    ``executors=`` on a save names the ``ParallelExecutor`` that holds
    vars split, as for ``save_sharded``."""

    def __init__(self, dirname, max_to_keep=3, save_interval_steps=1,
                 async_save=True):
        self._mgr = TrainStateCheckpointManager(
            dirname, max_to_keep=max_to_keep,
            save_interval_steps=save_interval_steps, async_save=async_save,
            sharded=True)

    def save(self, step, scope=None, program=None, executors=None):
        """Maybe save (interval-gated) at ``step``, asynchronously by
        default; False when gated."""
        return self._mgr.save(step, scope=scope, program=program,
                              executors=executors)

    def restore(self, scope=None, program=None, step=None, shardings=None):
        """Restore ``step`` (default: the newest artifact that loads).
        Returns the step, or None when no artifact exists."""
        return self._mgr.restore(scope=scope, program=program, step=step,
                                 shardings=shardings)

    def save_now(self, step, scope=None, program=None, executors=None):
        """A synchronous save past the interval gate (the preemption
        flush): drains an inflight write, then writes, a collective at a
        step every rank agreed on (``distributed.any_process_flagged``);
        returns once the artifact is committed on every rank."""
        step_dir = self._mgr._step_dir(step)
        _agreed("save_now", step_dir, lambda: self._mgr.save_now(
            step, scope=scope, program=program, executors=executors))
        _require_committed("save_now", step_dir)
        return True

    def latest_step(self):
        return self._mgr.latest_step()

    def all_steps(self):
        return self._mgr.all_steps()

    def wait_until_finished(self):
        self._mgr.wait_until_finished()

    def close(self):
        self._mgr.close()
