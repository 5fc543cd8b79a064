"""The port's sharded TrainState checkpoints (``paddle_tpu_torch/parallel/
checkpoint.py``) on the CPU, mirroring ``tests/test_sharded_checkpoint.py``
and the sharded-IO units of ``tests/test_cluster.py`` (``:348-470``,
``:565-586``).

Worlds of 2 and 4 gloo ranks (``torch_mesh_world``: each rank ``python
tests/test_torch_sharded_checkpoint.py --rank R ...``) train a small Adam
MLP through ``ParallelExecutor`` with the JAX package's sharding rules,
capture sharded (each rank copies out the blocks it owns, with no
collective) and write the per-writer layout; the parent checks the
ownership, reads the artifacts back and hands them to the JAX package;
a save that fails on one rank of the world raises on both.
In this process: the single-writer and 4-virtual-writer round trips, the
missing writer, the corrupt shard and the fallback, saver election, the
init's tmp reclaim, and the orbax API (``save_sharded``,
``load_sharded``, ``ShardedCheckpointManager``) over the same format.
Against the JAX package: a sharded artifact the JAX package writes on its
8-device virtual mesh (fsdp 4, 4 writers) loads in the port bit for bit,
the port's 4-rank artifact loads in the JAX package bit for bit, and a
bfloat16 var crosses both ways.  A ``cuda``-marked test (on the card:
``python -m pytest -m cuda tests/test_torch_sharded_checkpoint.py``)
resumes a captured entry from a sharded artifact."""

import json
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_world import error_of, run_world  # noqa: E402

# the var a test stores as bfloat16 (Adam's first moment of fc_1.w_0)
BF16_VAR = "fc_1.w_0_moment1_0"


def _build_mlp(pkg, seed=7):
    """``tests/test_cluster.py``'s ``_build_mlp``."""
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    x = pkg.layers.data("x", shape=[16])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(x, size=32, act="relu")
    pred = pkg.layers.fc(h, size=4, act=None)
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(pred, label))
    pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return loss


def _batch(i):
    x = np.random.RandomState(i).rand(8, 16).astype("float32")
    return {"x": x, "label": x[:, :4].argmax(1).astype("int64")
            .reshape(-1, 1)}


def _full_np(arrays):
    """{name: numpy} of torch tensors, bfloat16 as its bits (uint16)."""
    import torch

    out = {}
    for n, t in arrays.items():
        t = t.detach().cpu()
        out[n] = t.view(torch.int16).numpy().view("u2") \
            if t.dtype == torch.bfloat16 else t.numpy()
    return out


def _same_bits(a, b):
    """Whether two tensors hold the same dtype, shape and bits."""
    import torch

    def raw(t):
        return t.contiguous().view(-1).view(torch.uint8)
    return a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape) and \
        torch.equal(raw(a), raw(b))


def _jax_np(a):
    """A JAX-side array as numpy, bfloat16 as its bits (uint16)."""
    a = np.asarray(a)
    return a.view("u2") if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the ranks' cases
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter_tensor", "broadcast", "barrier",
                "all_gather_object", "broadcast_object_list", "send", "recv",
                "isend", "irecv", "batch_isend_irecv", "all_to_all_single",
                "gather", "scatter")


class _CountCollectives:
    """Counts every ``torch.distributed`` collective called inside."""

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self._saved = [], {}
        for name in _COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.calls.append(_name)
                return _fn(*a, **k)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _trained_pe(mesh_shape, steps=2):
    """The MLP trained ``steps`` steps through ParallelExecutor on a
    (dp, fsdp) ``mesh_shape`` mesh with the sharding rules."""
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    bs = pt.BuildStrategy()
    bs.sharding_rules = True
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             mesh=pt.make_mesh(mesh_shape, ("dp", "fsdp")),
                             build_strategy=bs)
    for i in range(steps):
        pe.run([loss], feed=_batch(i))
    return pe, loss


def _entries_out(ts, rank):
    """A rank's entries as arrays: names, flattened indices, sizes."""
    return {"names": np.array([e["name"] for e in ts.shards]),
            "index": np.array(json.dumps([e["index"] for e in ts.shards])),
            "sizes": np.array([int(e["data"].numel()) for e in ts.shards],
                              dtype=np.int64)}


def case_fsdp4(inputs, rank, world):
    """(dp 1, fsdp 4): a sharded capture with its collectives counted,
    the full (gathered) state beside it, every rank writing its own
    blocks as writer ``rank`` and rank 0 committing; then the manager in
    its default (sharded in a world) mode."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.parallel import checkpoint as ck
    from paddle_tpu_torch.parallel import distributed

    root = str(inputs["dir"])
    pe, _ = _trained_pe((1, 4))
    # the gathered state first (gloo gathers float32), then BF16_VAR's
    # block cast on each rank: the whole cast alike
    full = ck.capture_train_state(2, executors={"train": pe}).arrays
    full[BF16_VAR] = full[BF16_VAR].to(torch.bfloat16)
    scope = pt.global_scope()
    scope.set_var(BF16_VAR, scope.var(BF16_VAR).to(torch.bfloat16))
    with _CountCollectives() as counted:
        ts = ck.capture_train_state(2, executors={"train": pe}, sharded=True)
    art = os.path.join(root, "fsdp4", "step_0000000002")
    ck.save_train_state_sharded(art, ts, writer_id=rank, writers=world,
                                saver=rank == 0)
    distributed.barrier()
    loaded = ck.load_train_state(art).arrays
    same = sorted(loaded) == sorted(full) and all(
        _same_bits(loaded[n], full[n]) for n in full)
    # the manager in a world: sharded by default, every rank a writer
    events = []
    orig = monitor.log_event
    monitor.log_event = events.append
    try:
        mgr = ck.TrainStateCheckpointManager(os.path.join(root, "mgr4"),
                                             async_save=False)
        mgr.save(2, executors={"train": pe})
    finally:
        monitor.log_event = orig
    distributed.barrier()
    saved = [e for e in events if e.get("event") == "checkpoint_saved"]
    out = dict(_entries_out(ts, rank),
               collectives=np.array(counted.calls or ["none"]),
               loaded_equal=np.array(same),
               sharded_mode=np.array(mgr.sharded_mode()),
               event=np.array(json.dumps(
                   {k: saved[0].get(k) for k in ("sharded", "writer_id",
                                                  "writers", "saver")})))
    if rank == 0:
        out.update({"F:" + n: v for n, v in _full_np(full).items()})
    return out


def case_dp2fsdp2(inputs, rank, world):
    """(dp 2, fsdp 2): the entries each rank owns."""
    from paddle_tpu_torch.parallel import checkpoint as ck

    pe, _ = _trained_pe((2, 2))
    ts = ck.capture_train_state(2, executors=pe, sharded=True)
    full = ck.capture_train_state(2, executors=pe)
    out = _entries_out(ts, rank)
    out["shapes"] = np.array(json.dumps(
        {n: list(t.shape) for n, t in full.arrays.items()}))
    return out


def case_api2(inputs, rank, world):
    """A world of 2 (fsdp 2): ``save_sharded`` with the executor that
    holds the split vars, the full state beside it, then ``load_sharded``
    back into the live shards after they are zeroed; the manager's
    default mode."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    root = str(inputs["dir"])
    pe, _ = _trained_pe((1, 2))
    names = ck.save_sharded(os.path.join(root, "api2"), executors=pe)
    full = ck.capture_train_state(2, executors=pe)
    scope = pt.global_scope()
    for n in names:
        scope.set_var(n, torch.zeros_like(scope.var(n)))
    ck.load_sharded(os.path.join(root, "api2"),
                    shardings=pe.state_shardings())
    back = ck.capture_train_state(2, executors=pe)
    out = {"names": np.array(names),
           "reloaded_equal": np.array(all(
               torch.equal(back.arrays[n], full.arrays[n]) for n in names)),
           "sharded_mode": np.array(ck.TrainStateCheckpointManager(
               os.path.join(root, "mode2")).sharded_mode())}
    if rank == 0:
        out.update({"F:" + n: v for n, v in _full_np(full.arrays).items()})
    return out


def case_fail2(inputs, rank, world):
    """A world of 2 (fsdp 2) whose sharded saves fail on one rank: a peer
    whose ``save_sharded`` write raises, then a saver whose
    ``ShardedCheckpointManager.save_now`` commit raises.  Each failure
    must raise on both ranks (no rank left waiting in a collective), and
    a clean ``save_sharded`` must work after them."""
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.parallel import checkpoint as ck

    root = str(inputs["dir"])
    pe, _ = _trained_pe((1, 2))

    def boom(step, **_):
        raise OSError("disk full (injected)")

    def attempt(point, failing_rank, save):
        hook = fault.register(point, boom, fault.FaultSchedule(every=1)) \
            if rank == failing_rank else None
        try:
            save()
        except Exception as e:  # noqa: BLE001 — the message is the result
            return "%s: %s" % (type(e).__name__, e)
        finally:
            if hook is not None:
                fault.unregister(hook)
        return ""

    out = {"write_error": np.array(attempt(
        "checkpoint/before_write", 1,
        lambda: ck.save_sharded(os.path.join(root, "fail_write"),
                                executors=pe)))}
    mgr = ck.ShardedCheckpointManager(os.path.join(root, "fail_commit"),
                                      async_save=False)
    out["commit_error"] = np.array(attempt(
        "checkpoint/before_commit", 0,
        lambda: mgr.save_now(3, executors=pe)))
    out["then_saved"] = np.array(ck.save_sharded(
        os.path.join(root, "after_fail"), executors=pe))
    if rank == 0:
        out["left"] = np.array(sorted(
            e for d in ("fail_write", "fail_commit", "after_fail")
            for e in (os.listdir(os.path.join(root, d))
                      if os.path.isdir(os.path.join(root, d)) else [])) +
            sorted(e for e in os.listdir(root) if e.startswith(".tmp.")))
    return out


def case_load4(inputs, rank, world):
    """The world of 2's ``save_sharded`` artifact onto a (dp 1, fsdp 4)
    world: ``load_sharded`` with this mesh's shardings puts each rank's
    block in the scope (returned with its index), and a step runs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    loss = _build_mlp(pt)
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    bs = pt.BuildStrategy()
    bs.sharding_rules = True
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             mesh=pt.make_mesh((1, 4), ("dp", "fsdp")),
                             build_strategy=bs)
    ck.load_sharded(str(inputs["art"]), shardings=pe.state_shardings())
    ts = ck.capture_train_state(0, executors=pe, sharded=True)
    out = _entries_out(ts, rank)
    out.update({"B%d:%s" % (i, e["name"]): e["data"].numpy()
                for i, e in enumerate(ts.shards)})
    (lv,) = pe.run([loss], feed=_batch(5))
    out["loss"] = np.asarray(lv)
    return out


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_world2")
    res = run_world(os.path.abspath(__file__), 2, ["api2", "fail2"], tmp,
                    {"api2": {"dir": np.array(str(tmp))},
                     "fail2": {"dir": np.array(str(tmp / "fail2"))}})
    for case in res.values():
        for r in case:
            assert not error_of(r), r.get("__trace__")
    return res, str(tmp / "api2")


@pytest.fixture(scope="module")
def world4(tmp_path_factory, world2):
    tmp = tmp_path_factory.mktemp("sharded_world4")
    res = run_world(os.path.abspath(__file__), 4,
                    ["fsdp4", "dp2fsdp2", "load4"], tmp,
                    {"fsdp4": {"dir": np.array(str(tmp))},
                     "load4": {"art": np.array(world2[1])}})
    for case in res.values():
        for r in case:
            assert not error_of(r), r.get("__trace__")
    return res, str(tmp)


def _cover(results, shapes):
    """{name: int array counting how often each element is owned}."""
    cover = {n: np.zeros(s, dtype=np.int64) for n, s in shapes.items()}
    for r in results:
        for n, idx in zip(r["names"].tolist(),
                          json.loads(str(r["index"]))):
            cover[n][tuple(slice(a, b) for a, b in idx)] += 1
    return cover


def _full_of(result):
    return {k[2:]: v for k, v in result.items() if k.startswith("F:")}


def test_sharded_capture_owns_disjoint_covering_shards(world4):
    """(dp 1, fsdp 4): the ranks' blocks cover every var exactly once,
    some var is split (more than one rank holds a piece of it), and the
    capture called no collective."""
    res = world4[0]["fsdp4"]
    full = _full_of(res[0])
    cover = _cover(res, {n: v.shape for n, v in full.items()})
    for n, c in cover.items():
        assert (c == 1).all(), (n, c)
    owners = {}
    for rank, r in enumerate(res):
        for n in r["names"].tolist():
            owners.setdefault(n, set()).add(rank)
    assert any(len(o) == 4 for o in owners.values()), owners
    assert sum(len(r["names"]) for r in res[1:]) > 0
    for r in res:
        assert r["collectives"].tolist() == ["none"], r["collectives"]


def test_dp2_fsdp2_owns_each_block_once(world4):
    """(dp 2, fsdp 2): each block is written once, by a dp-0 rank; the
    dp-1 ranks hold replicas and write nothing."""
    res = world4[0]["dp2fsdp2"]
    shapes = {n: tuple(s) for n, s in json.loads(str(res[0]["shapes"]))
              .items()}
    for n, c in _cover(res, shapes).items():
        assert (c == 1).all(), (n, c)
    # row-major (dp, fsdp): ranks 0, 1 are dp 0; ranks 2, 3 are dp 1
    assert len(res[0]["names"]) and len(res[1]["names"])
    assert len(res[2]["names"]) == len(res[3]["names"]) == 0


def test_world_artifact_round_trips_bit_identical(world4):
    """The 4-writer artifact of the world (each rank its own blocks, rank
    0's commit) loads, on every rank and here, to the gathered state bit
    for bit; the bfloat16 var keeps its bits."""
    import torch

    from paddle_tpu_torch.parallel import checkpoint as ck

    res, root = world4
    full = _full_of(res["fsdp4"][0])
    assert all(bool(r["loaded_equal"]) for r in res["fsdp4"])
    art = os.path.join(root, "fsdp4", "step_0000000002")
    man = json.load(open(os.path.join(art, "MANIFEST.json")))
    assert man["sharded"] and man["writers"] == 4
    loaded = ck.load_train_state(art)
    assert loaded.arrays[BF16_VAR].dtype == torch.bfloat16
    got = _full_np(loaded.arrays)
    assert sorted(got) == sorted(full)
    for n, v in full.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)


def test_world_manager_writes_sharded_by_default(world4):
    """In a world of 4 the manager's default is sharded: four writers,
    rank 0 the saver, and each ``checkpoint_saved`` event says so."""
    res, root = world4
    for rank, r in enumerate(res["fsdp4"]):
        assert bool(r["sharded_mode"])
        ev = json.loads(str(r["event"]))
        assert ev == {"sharded": True, "writer_id": rank, "writers": 4,
                      "saver": rank == 0}, ev
    step = os.path.join(root, "mgr4", "step_0000000002")
    files = sorted(os.listdir(step))
    assert files == sorted(["MANIFEST.json", "train_state.json"]
                           + ["shard_%05d.%s" % (w, x) for w in range(4)
                              for x in ("npz", "json")])


def test_port_world_artifact_loads_in_jax(world4):
    """The JAX package's ``load_train_state`` reads the port's 4-rank
    artifact to the port's whole state, bfloat16 included."""
    from paddle_tpu.parallel import checkpoint as jax_ck

    res, root = world4
    full = _full_of(res["fsdp4"][0])
    got = jax_ck.load_train_state(os.path.join(root, "fsdp4",
                                               "step_0000000002")).arrays
    assert np.asarray(got[BF16_VAR]).dtype.name == "bfloat16"
    assert sorted(got) == sorted(full)
    for n, v in full.items():
        np.testing.assert_array_equal(_jax_np(got[n]), v, err_msg=n)


def test_sharded_mode_follows_the_world(world2, world4, tmp_path):
    from paddle_tpu_torch.parallel import checkpoint as ck

    assert ck.TrainStateCheckpointManager(str(tmp_path)).sharded_mode() \
        is False
    assert ck.TrainStateCheckpointManager(
        str(tmp_path), sharded=True).sharded_mode() is True
    assert all(bool(r["sharded_mode"]) for r in world2[0]["api2"])
    assert all(bool(r["sharded_mode"]) for r in world4[0]["fsdp4"])


def test_sharded_save_failure_raises_on_every_rank(world2):
    """A ``save_sharded`` whose peer cannot write, and a
    ``ShardedCheckpointManager.save_now`` whose saver cannot commit, raise
    on both ranks of the world, leave no artifact and no tmp directory,
    and the next ``save_sharded`` commits."""
    res = world2[0]["fail2"]
    for rank, r in enumerate(res):
        write, commit = str(r["write_error"]), str(r["commit_error"])
        assert ("disk full" in write) == (rank == 1), write
        assert "a peer rank failed" in write or rank == 1, write
        assert ("disk full" in commit) == (rank == 0), commit
        assert "a peer rank failed" in commit or rank == 0, commit
        assert r["then_saved"].size > 0
    assert res[0]["left"].tolist() == [
        "MANIFEST.json", "shard_00000.json", "shard_00000.npz",
        "shard_00001.json", "shard_00001.npz", "train_state.json"]


def test_save_load_sharded_across_world_sizes(world2, world4, tmp_path):
    """``save_sharded`` in a world of 2 round-trips there
    (``load_sharded`` into the live shards), restores onto a world of 4
    (each rank's block, and a step runs) and onto one process (whole)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    res2, art = world2
    full = _full_of(res2["api2"][0])
    assert all(bool(r["reloaded_equal"]) for r in res2["api2"])
    man = json.load(open(os.path.join(art, "MANIFEST.json")))
    assert man["sharded"] and man["writers"] == 2
    load4 = world4[0]["load4"]
    cover = {n: np.zeros(v.shape, dtype=np.int64) for n, v in full.items()}
    for r in load4:
        for i, (n, idx) in enumerate(zip(r["names"].tolist(),
                                         json.loads(str(r["index"])))):
            sel = tuple(slice(a, b) for a, b in idx)
            np.testing.assert_array_equal(r["B%d:%s" % (i, n)],
                                          full[n][sel], err_msg=n)
            cover[n][sel] += 1
        assert np.isfinite(r["loss"]).all()
    for n, c in cover.items():
        assert (c == 1).all(), n
    assert sorted(set(str(n) for r in load4 for n in r["names"])) != []
    _build_mlp(pt, seed=3)
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    names = ck.load_sharded(art)
    assert names == sorted(full)
    scope = pt.global_scope()
    for n, v in full.items():
        np.testing.assert_array_equal(scope.var(n).numpy(), v, err_msg=n)


# -- one process --------------------------------------------------------------

_CAPTURE = []


def _trained(steps=2):
    """The MLP trained ``steps`` steps on the CPU; (loss, executor)."""
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    for i in range(steps):
        exe.run(feed=_batch(i), fetch_list=[loss])
    return loss, exe


def _cached_capture():
    """One (sharded capture, full arrays) for the pure-IO tests, with
    BF16_VAR as bfloat16."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    if not _CAPTURE:
        with pt.unique_name.guard(), \
                pt.program_guard(pt.Program(), pt.Program()), \
                pt.scope_guard(pt.Scope()):
            _, exe = _trained()
            scope = pt.global_scope()
            scope.set_var(BF16_VAR, scope.var(BF16_VAR).to(torch.bfloat16))
            ts = ck.capture_train_state(2, executors=exe, sharded=True)
            full = ck.capture_train_state(2, executors=exe).arrays
        _CAPTURE.append((ts, full))
    return _CAPTURE[0]


def test_sharded_single_writer_roundtrip_bit_identical(tmp_path):
    import torch

    from paddle_tpu_torch.parallel import checkpoint as ck

    ts, full = _cached_capture()
    assert ts.arrays is None and len(ts.shards) == len(full)
    assert repr(ts).startswith("TrainState(step=2, shards=")
    art = str(tmp_path / "step_0000000002")
    assert ck.save_train_state_sharded(art, ts) == art
    loaded = ck.load_train_state(art)
    assert sorted(loaded.arrays) == sorted(full)
    for n, v in full.items():
        assert v.dtype == loaded.arrays[n].dtype, n
        assert torch.equal(loaded.arrays[n], v), n
    assert loaded.host["executors"]["executor0"] == \
        ts.host["executors"]["executor0"]
    meta = json.load(open(os.path.join(art, "train_state.json")))[
        "array_meta"]
    assert meta[BF16_VAR]["dtype"] == "bfloat16"
    assert meta[BF16_VAR]["raw_dtype"] == "uint16"


def test_partition_shards_bytes_scale_inverse_n(tmp_path):
    """4 virtual writers: each holds under 0.35 of the bytes (the
    manifest's ``per_writer_bytes``), and the artifact loads bit for bit
    here and in the JAX package."""
    import torch

    from paddle_tpu.parallel import checkpoint as jax_ck
    from paddle_tpu_torch.parallel import checkpoint as ck

    ts, full = _cached_capture()
    art = str(tmp_path / "v4" / "step_0000000002")
    parts = ck.partition_shards(ts, 4)
    assert len(parts) == 4
    for w, entries in enumerate(parts):
        ck.write_train_state_shards(art, ts, w, entries=entries)
    ck.commit_sharded_train_state(art, ts, 4)
    per = json.load(open(os.path.join(art, "MANIFEST.json")))[
        "per_writer_bytes"]
    assert len(per) == 4
    assert max(per.values()) / sum(per.values()) < 0.35, per
    loaded = ck.load_train_state(art)
    for n, v in full.items():
        assert torch.equal(loaded.arrays[n], v), n
    jax_arrays = jax_ck.load_train_state(art).arrays
    for n, v in _full_np(full).items():
        np.testing.assert_array_equal(_jax_np(jax_arrays[n]), v, err_msg=n)


def test_sharded_commit_times_out_on_missing_writer(tmp_path):
    from paddle_tpu_torch.parallel import checkpoint as ck

    ts, _ = _cached_capture()
    art = str(tmp_path / "step_0000000002")
    ck.write_train_state_shards(art, ts, 0)
    with pytest.raises(ck.CheckpointCorruptError, match="never delivered"):
        ck.commit_sharded_train_state(art, ts, 2, timeout=0.2)
    assert not os.path.exists(os.path.join(art, "MANIFEST.json"))


def test_sharded_corrupt_shard_detected_and_fallback(tmp_path):
    """A garbled shard fails its sha256; the manager falls back one
    artifact with a "corrupt" warning and restores it bit for bit."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    loss, exe = _trained()
    prog = pt.default_main_program()
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "mgr"),
                                         sharded=True, async_save=False)
    mgr.save(2, program=prog, executors={"train": exe})
    want = ck.capture_train_state(2, program=prog).arrays
    for i in range(2):
        exe.run(feed=_batch(i + 2), fetch_list=[loss])
    mgr.save(4, program=prog, executors={"train": exe})
    assert mgr.all_steps() == [2, 4]
    with open(os.path.join(mgr._step_dir(4), "shard_00000.npz"), "r+b") as f:
        f.seek(12)
        f.write(b"\xff" * 32)
    with pytest.raises(ck.CheckpointCorruptError, match="sha256"):
        mgr.load(4)
    with pt.scope_guard(pt.Scope()):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
        with pytest.warns(UserWarning, match="corrupt"):
            assert mgr.restore(program=prog) == 2
        scope = pt.global_scope()
        for n, v in want.items():
            np.testing.assert_array_equal(scope.var(n).numpy(), v.numpy(),
                                          err_msg=n)


def test_manager_saver_election_gates_commit(tmp_path):
    """A writer that is not elected writes its shards and never the
    manifest; the artifact shows once an elected saver commits."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    _trained()
    prog = pt.default_main_program()
    mgr = ck.TrainStateCheckpointManager(
        str(tmp_path / "mgr"), sharded=True, async_save=False,
        saver_elect=lambda step: False)
    mgr.save(2, program=prog)
    assert mgr.all_steps() == []
    assert os.listdir(str(tmp_path / "mgr")) == [".tmp.step_0000000002.shared"]
    mgr2 = ck.TrainStateCheckpointManager(
        str(tmp_path / "mgr2"), sharded=True, async_save=False,
        saver_elect=lambda step: True)
    mgr2.save(2, program=prog)
    assert mgr2.all_steps() == [2]


def test_manager_init_spares_fresh_shared_tmp_reclaims_stale(tmp_path):
    """The init keeps a shared tmp younger than the commit timeout (a
    live peer's write) and reclaims an older one and every pid-suffixed
    tmp."""
    from paddle_tpu_torch.parallel import checkpoint as ck

    d = str(tmp_path / "mgr")
    os.makedirs(d)
    fresh = os.path.join(d, ".tmp.step_0000000009.shared")
    stale = os.path.join(d, ".tmp.step_0000000003.shared")
    plain = os.path.join(d, ".tmp.step_0000000004.123")
    for p in (fresh, stale, plain):
        os.makedirs(p)
        with open(os.path.join(p, "shard_00000.json"), "w") as f:
            f.write("{}")
    old = time.time() - 999.0
    os.utime(stale, (old, old))
    ck.TrainStateCheckpointManager(d, sharded=True, commit_timeout=120.0)
    assert os.path.isdir(fresh)
    assert not os.path.exists(stale)
    assert not os.path.exists(plain)


def test_full_capture_path_unchanged_single_host(tmp_path):
    """One process: the manager's default stays the full artifact."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    _trained(steps=0)
    mgr = ck.TrainStateCheckpointManager(str(tmp_path / "m"),
                                         async_save=False)
    assert mgr.sharded_mode() is False
    mgr.save(1, program=pt.default_main_program())
    art = mgr._step_dir(1)
    assert os.path.exists(os.path.join(art, "arrays.npz"))
    assert not json.load(open(os.path.join(art, "MANIFEST.json"))).get(
        "sharded")


def test_sharded_incremental_cadence_desync_refused(tmp_path):
    """A peer's delta entries under a saver's full artifact: the commit
    is refused and nothing lands."""
    from paddle_tpu_torch.parallel import checkpoint as ck

    ts, _ = _cached_capture()
    art = str(tmp_path / "step_0000000002")
    e = dict(next(x for x in ts.shards if x["data"].dim() == 2))
    e["rows"] = np.zeros(1, np.int64)
    e["data"] = e["data"][:1]
    ck.write_train_state_shards(art, ts, 0, entries=[e])
    with pytest.raises(ck.CheckpointCorruptError, match="desynchronized"):
        ck.commit_sharded_train_state(art, ts, 1)
    assert not os.path.exists(art)


# -- the orbax API ------------------------------------------------------------

def test_sharded_roundtrip_and_mesh_shardings(tmp_path):
    """``save_sharded`` / ``load_sharded`` in one process, into a scope
    after a fresh startup, whole and with a (dp 1) mesh's shardings."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    loss, _ = _trained()
    prog = pt.default_main_program()
    before = {n: t.clone() for n, t in ck.capture_train_state(
        0, program=prog).arrays.items()}
    names = ck.save_sharded(str(tmp_path / "ck"), program=prog)
    assert names == sorted(before) and "fc_0.w_0" in names
    for shard in (False, True):
        with pt.scope_guard(pt.Scope()):
            pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
            sh = None
            if shard:
                sh = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                         main_program=prog).state_shardings()
            assert ck.load_sharded(str(tmp_path / "ck"), program=prog,
                                   shardings=sh) == names
            scope = pt.global_scope()
            for n, v in before.items():
                np.testing.assert_array_equal(scope.var(n).numpy(),
                                              v.numpy(), err_msg=n)


def test_sharded_manager_rotation_and_interval(tmp_path):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    _trained(steps=1)
    prog = pt.default_main_program()
    scope = pt.global_scope()
    mgr = ck.ShardedCheckpointManager(str(tmp_path / "mgr"), max_to_keep=2,
                                      save_interval_steps=2,
                                      async_save=False)
    saved = [s for s in range(6) if mgr.save(s, scope, prog)]
    mgr.wait_until_finished()
    assert saved == [0, 2, 4]
    assert mgr.all_steps() == [2, 4] and mgr.latest_step() == 4
    art = os.path.join(str(tmp_path / "mgr"), "step_0000000004")
    assert json.load(open(os.path.join(art, "MANIFEST.json")))["sharded"]
    want = scope.var("fc_0.w_0").clone()
    scope.set_var("fc_0.w_0", want * 0)
    assert mgr.restore(scope, prog) == 4
    np.testing.assert_array_equal(scope.var("fc_0.w_0").numpy(),
                                  want.numpy())
    mgr.close()


def test_save_now_bypasses_interval(tmp_path):
    """``save_now`` flushes whatever the interval (the preemption path),
    and the asynchronous ``save`` lands before it."""
    from paddle_tpu_torch.parallel import checkpoint as ck

    _trained(steps=0)
    mgr = ck.ShardedCheckpointManager(str(tmp_path / "m"),
                                      save_interval_steps=100)
    assert mgr.save(step=0)
    assert mgr.save(step=3) is False
    assert mgr.save_now(step=3)
    assert mgr.all_steps() == [0, 3] and mgr.latest_step() == 3
    assert mgr.restore() == 3
    mgr.close()


def test_restore_before_startup_raises(tmp_path):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    _build_mlp(pt)
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    ck.save_sharded(str(tmp_path / "ck3"))
    mgr = ck.ShardedCheckpointManager(str(tmp_path / "m"), async_save=False)
    mgr.save(1)
    with pt.scope_guard(pt.Scope()):
        with pytest.raises(ValueError, match="startup"):
            ck.load_sharded(str(tmp_path / "ck3"))
        with pytest.raises(ValueError, match="startup"):
            mgr.restore()
    assert ck.ShardedCheckpointManager(str(tmp_path / "none")).restore() \
        is None


# -- the JAX package's artifact -----------------------------------------------

def test_jax_sharded_artifact_loads_in_port(tmp_path):
    """The JAX package trains on its 8-device virtual mesh under fsdp 4,
    holds BF16_VAR as bfloat16, captures sharded and writes 4 writers;
    the port's ``load_train_state`` reads every var bit for bit (the
    bfloat16 one as ``torch.bfloat16``)."""
    import jax
    import ml_dtypes
    import torch

    import paddle_tpu as fluid
    from paddle_tpu.parallel import checkpoint as jax_ck
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu_torch.parallel import checkpoint as ck

    loss = _build_mlp(fluid)
    bs = fluid.BuildStrategy()
    bs.sharding_rules = True
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
        pe = fluid.ParallelExecutor(
            loss_name=loss.name, mesh=make_mesh((1, 4), ("dp", "fsdp")),
            build_strategy=bs)
        for i in range(2):
            pe.run(feed=_batch(i), fetch_list=[loss])
        v = scope.var(BF16_VAR)
        scope.set_var(BF16_VAR, jax.device_put(
            np.asarray(v).astype(ml_dtypes.bfloat16), v.sharding))
        ts = jax_ck.capture_train_state(2, scope=scope, executors=pe,
                                        sharded=True)
        full = {n: jax_ck._gather_host(x) for n, x in
                jax_ck._persistable_state(
                    scope, fluid.default_main_program()).items()}
    assert any(e["data"].size < full[e["name"]].size for e in ts.shards)
    art = str(tmp_path / "step_0000000002")
    for w, entries in enumerate(jax_ck.partition_shards(ts, 4)):
        jax_ck.write_train_state_shards(art, ts, w, entries=entries)
    jax_ck.commit_sharded_train_state(art, ts, 4)
    got = ck.load_train_state(art)
    assert got.arrays[BF16_VAR].dtype == torch.bfloat16
    assert sorted(got.arrays) == sorted(full)
    got = _full_np(got.arrays)
    for n, v in full.items():
        np.testing.assert_array_equal(got[n], _jax_np(v), err_msg=n)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_captured_sharded_resume_is_bit_identical(tmp_path, monkeypatch):
    """8 captured steps straight, against 4, a sharded save as 4 virtual
    writers, a fresh executor and scope restored from it and 4 more:
    equal loss bits and state, one graph an entry."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step runs on a card")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import checkpoint as ck

    card = pt.CUDAPlace(0)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    loss = _build_mlp(pt)
    main, startup = pt.default_main_program(), pt.default_startup_program()
    feeds = [_batch(i) for i in range(8)]

    def fresh():
        scope = pt.Scope()
        pt.Executor(card).run(startup, scope=scope)
        return scope, pt.Executor(card)

    def state(scope):
        return {v.name: scope.find_var(v.name).detach().cpu().clone()
                for v in main.list_vars()
                if v.persistable and scope.find_var(v.name) is not None}

    scope, exe = fresh()
    ref = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           .tobytes() for f in feeds]
    want = state(scope)
    scope, exe = fresh()
    got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           .tobytes() for f in feeds[:4]]
    ts = ck.capture_train_state(4, scope=scope, program=main,
                                executors={"train": exe}, sharded=True)
    art = str(tmp_path / "step_0000000004")
    for w, entries in enumerate(ck.partition_shards(ts, 4)):
        ck.write_train_state_shards(art, ts, w, entries=entries)
    ck.commit_sharded_train_state(art, ts, 4)
    scope, exe = fresh()
    ck.apply_train_state(ck.load_train_state(art), scope=scope,
                         program=main, executors={"train": exe})
    got += [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            .tobytes() for f in feeds[4:]]
    assert got == ref
    for n, t in state(scope).items():
        assert torch.equal(t, want[n]), n
    assert sorted(st.graphs for st in exe._steps.values()) == [1]


@pytest.fixture(autouse=True)
def _fresh(request):
    """Fresh port programs, scope and name counter for every test (the
    JAX package's are conftest's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework, unique_name

    old_main = framework.switch_main_program(pt.Program())
    old_startup = framework.switch_startup_program(pt.Program())
    old_gen = unique_name.switch()
    pt.compile_cache.clear()
    with pt.scope_guard(pt.Scope()):
        yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
