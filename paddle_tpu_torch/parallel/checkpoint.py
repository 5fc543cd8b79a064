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
collective: every rank captures), and the manager writes on rank 0
alone; ``apply_train_state(shardings=pe.state_shardings())`` puts each
rank's shard of a whole artifact in the scope (without ``shardings`` the
executor cuts whole values at its next run).

Not ported yet, and refused naming ROADMAP A7c (the sharded writers):
the orbax half (``save_sharded``, ``load_sharded``,
``ShardedCheckpointManager``), the multi-writer sharded protocol
(``partition_shards``, ``write_train_state_shards``,
``commit_sharded_train_state``, ``save_train_state_sharded``) and the
manager's sharded mode.
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


def _needs_a7(what):
    raise NotImplementedError(
        "%s is not ported to paddle_tpu_torch yet: it needs a process "
        "group's writers (ROADMAP A7c); use the TrainState checkpoints "
        "(TrainStateCheckpointManager)" % what)


def save_sharded(dirname, scope=None, program=None):
    _needs_a7("save_sharded (the orbax checkpoint)")


def load_sharded(dirname, scope=None, program=None, shardings=None):
    _needs_a7("load_sharded (the orbax checkpoint)")


class ShardedCheckpointManager:
    def __init__(self, *args, **kwargs):
        _needs_a7("ShardedCheckpointManager (the orbax checkpoint)")


def partition_shards(ts, writers):
    _needs_a7("partition_shards (the sharded TrainState protocol)")


def write_train_state_shards(dirname, ts, writer_id, entries=None):
    _needs_a7("write_train_state_shards (the sharded TrainState protocol)")


def commit_sharded_train_state(dirname, ts, expected_writers, timeout=120.0,
                               **kwargs):
    _needs_a7("commit_sharded_train_state (the sharded TrainState "
              "protocol)")


def save_train_state_sharded(dirname, ts, writer_id=0, writers=1,
                             saver=True, commit_timeout=120.0):
    _needs_a7("save_train_state_sharded (the sharded TrainState protocol)")


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
    """Apply one var's delta ops onto a private, mutable tensor."""
    for op in ops:
        kind, sel, data = op[0], op[1], op[2]
        if kind != "rows":
            raise CheckpointCorruptError("unknown delta op kind %r" % kind)
        rows = torch.as_tensor(sel, dtype=torch.int64)
        target[rows] = data.reshape((len(rows),) + tuple(target.shape[1:]))
    return target


class TrainState:
    """One snapshot at a step boundary: ``arrays`` ({name: CPU tensor})
    and ``host`` (JSON-able: step, executor and reader states, caller
    extras).  An incremental artifact read straight off disk also carries
    ``delta`` ({name: [("rows", rows, values)]}) and is not
    self-contained: the manager's ``load`` replays its chain."""

    def __init__(self, step, arrays, host, delta=None):
        self.step = int(step)
        self.arrays = arrays
        self.host = host
        self.delta = delta

    def __repr__(self):
        return "TrainState(step=%d, arrays=%d, executors=%s, readers=%s)" % (
            self.step, len(self.arrays),
            sorted(self.host.get("executors", {})),
            sorted(self.host.get("readers", {})))


def capture_train_state(step, scope=None, program=None, executors=None,
                        readers=None, extra=None, sharded=False):
    """Snapshot the train state at a step boundary.  Blocks only for the
    device-to-host copy of the persistable vars; whoever writes the
    snapshot serializes it (on the async path, under the next steps).
    ``executors`` / ``readers`` expose ``state_dict()``; the restoring side
    passes the same names."""
    if sharded:
        _needs_a7("capture_train_state(sharded=True)")
    with RecordEvent("checkpoint/snapshot"):
        scope = scope or global_scope()
        state = _persistable_state(scope, program)
        _require_state(state, "snapshot")
        for e in _named(executors, "executor").values():
            gather = getattr(e, "gathered_state", None)
            if gather is not None:
                state = gather(state, program)
        host = {
            "format": TRAIN_STATE_FORMAT,
            "step": int(step),
            "time": time.time(),
            "executors": {n: dict(e.state_dict())
                          for n, e in _named(executors, "executor").items()},
            "readers": {n: dict(r.state_dict())
                        for n, r in _named(readers, "reader").items()},
            "extra": dict(extra or {}),
        }
        arrays = {n: _host_copy(v) for n, v in state.items()}
    return TrainState(step, arrays, host)


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
    """Read and check one artifact; ``CheckpointCorruptError`` on a
    missing, partial or garbled one (no manifest, a checksum mismatch, an
    undecodable payload)."""
    dirname = os.path.abspath(dirname)
    try:
        with open(os.path.join(dirname, _MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            "checkpoint %s: unreadable manifest (%s) — likely a partial "
            "write" % (dirname, e))
    if manifest.get("sharded"):
        _needs_a7("loading a sharded TrainState artifact")
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
    artifacts.  ``sharded=True`` waits for ROADMAP A7c."""

    def __init__(self, dirname, max_to_keep=3, save_interval_steps=1,
                 async_save=True, sharded=None, incremental=None,
                 incremental_full_every=8):
        if sharded:
            _needs_a7("TrainStateCheckpointManager(sharded=True)")
        self._dir = os.path.abspath(dirname)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max(1, int(max_to_keep)) \
            if max_to_keep is not None else None
        self._interval = max(1, int(save_interval_steps))
        self._async = bool(async_save)
        self._last_saved = None
        self._inflight = None            # (thread, step)
        self._error = None
        self._incremental = incremental
        self._full_every = max(1, int(incremental_full_every))
        self._incr_base = {}         # {name: tensor} of the last artifact
        self._incr_base_step = None  # step of the generation's full base
        self._incr_prev_step = None  # step of the last written artifact
        self._deltas_since_full = 0
        # the measured costs of the latest saves: the snapshot on the
        # caller's thread and the write
        self._snapshot_s = collections.deque(maxlen=16)
        self._save_s = collections.deque(maxlen=16)
        self._mu = threading.Lock()
        self.last_restored = None        # TrainState of the last restore
        # a dead process's .tmp. dirs (a kill mid-save) are garbage
        for entry in os.listdir(self._dir):
            if entry.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self._dir, entry),
                              ignore_errors=True)

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

    # -- incremental (delta) encoding ----------------------------------
    def _resolve_incr_names(self, program, ts):
        """{var name: table height or None} this artifact may
        delta-encode (resolved on the save path: 'auto' needs the
        program)."""
        if not self._incremental:
            return None
        names = set(ts.arrays)
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
            self._incr_base = {}
            return
        self._incr_base = {n: ts.arrays[n].clone()
                           for n in inc.get("delta_vars", [])
                           if n in ts.arrays}
        self._incr_base_step = int(inc["base_step"])
        self._incr_prev_step = int(ts.step)
        # restart the full cadence from here, conservatively
        self._deltas_since_full = 1

    # -- save ----------------------------------------------------------
    def _snapshot(self, step, scope, program, executors, readers, extra):
        t0 = time.perf_counter()
        ts = capture_train_state(step, scope=scope, program=program,
                                 executors=executors, readers=readers,
                                 extra=extra)
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
        flush): joins an inflight write and returns once the artifact is
        committed.  A step already committed by this manager is not
        written again."""
        self._reraise()
        self.wait_until_finished()
        if self._last_saved == int(step) and os.path.exists(
                os.path.join(self._step_dir(step), _MANIFEST_FILE)):
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

        if distributed.process_id() != 0:
            return           # one writer: rank 0 (the state is gathered)
        t0 = time.perf_counter()
        # the diff runs here, in the writer, with the rest of the
        # serialization
        self._encode_incremental(ts, getattr(ts, "_incr_names", None))
        inc = ts.host.get("incremental")
        nbytes = sum(_nbytes(a) for a in ts.arrays.values())
        nbytes += sum(_nbytes(rows) + _nbytes(values)
                      for ops in (ts.delta or {}).values()
                      for _, rows, values in ops)
        with RecordEvent("checkpoint/save"):
            path = save_train_state(self._step_dir(ts.step), ts)
        extra = {}
        if inc:
            extra = {"incremental": True, "base_step": inc["base_step"],
                     "delta_rows": inc.get("delta_rows")}
            monitor.count("checkpoint/incremental_saves")
            monitor.count("checkpoint/incremental_rows",
                          sum((inc.get("delta_rows") or {}).values()))
        self._save_s.append(time.perf_counter() - t0)
        self._rotate()
        monitor.mark("checkpoint/saved")
        monitor.log_event(dict({
            "event": "checkpoint_saved", "ts": time.time(),
            "step": ts.step, "path": path,
            "seconds": round(time.perf_counter() - t0, 6),
            "bytes": nbytes, "async": self._async}, **extra))
        return path

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
            self._last_saved = restored
            self._seed_incremental_base(ts)
            monitor.log_event({"event": "checkpoint_restored",
                               "ts": time.time(), "step": restored})
            return restored
        return None

    def close(self):
        self.wait_until_finished()
