"""The port's incremental table checkpoints on the CPU, mirroring
``tests/test_incremental_checkpoint.py``: bitwise row deltas against a
periodic full base, chain replay, chain-aware rotation, a restore that
continues the chain, exact resume from a delta artifact, and the sharded
leg (4 virtual writers, each diffing only its own block).  Against the
JAX package: a delta chain either package wrote replays in the other to
the same arrays, and so does a sharded delta chain the JAX package
wrote."""

import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.parallel import checkpoint as jax_ck

import paddle_tpu_torch as pt
from paddle_tpu_torch import fault, guardian, monitor
from paddle_tpu_torch.parallel import checkpoint as port_ck
from paddle_tpu_torch.parallel.checkpoint import (
    CheckpointCorruptError, TrainStateCheckpointManager, load_train_state,
    row_delta, sparse_table_state_vars)

from test_torch_serving import fresh_torch_programs  # noqa: F401

V, D, B = 64, 8, 8


@pytest.fixture(autouse=True)
def _clean(fresh_torch_programs):  # noqa: F811
    monitor.reset_for_tests()
    fault.clear()
    guardian.uninstall()
    yield
    fault.clear()
    guardian.uninstall()
    monitor.reset_for_tests()


def _build(pkg=pt, vocab=V, seed=9):
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    ids = pkg.layers.data("ids", shape=[4, 1], dtype="int64")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    emb = pkg.layers.embedding(ids, size=[vocab, D], is_sparse=True,
                               param_attr=pkg.ParamAttr(name="table"))
    pred = pkg.layers.fc(pkg.layers.reduce_mean(emb, dim=1), size=1,
                         param_attr=pkg.ParamAttr(name="fc_w"),
                         bias_attr=pkg.ParamAttr(name="fc_b"))
    loss = pkg.layers.mean(pkg.layers.square(
        pkg.layers.elementwise_sub(pred, y)))
    pkg.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return loss


def _batches(n, seed=0, vocab=V):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, vocab, (B, 4, 1)).astype("int64"),
             "y": rng.rand(B, 1).astype("float32")} for _ in range(n)]


def _mgr(root, pkg_ck=None, **kw):
    kw.setdefault("async_save", False)
    kw.setdefault("incremental", "auto")
    kw.setdefault("incremental_full_every", 4)
    kw.setdefault("max_to_keep", None)
    cls = (pkg_ck or TrainStateCheckpointManager)
    return cls(os.path.join(str(root), "ck"), **kw)


def _delta_vars(scope, program):
    return {v.name: scope.find_var(v.name).clone()
            for v in program.list_vars()
            if v.name == "table" or (v.name.startswith("table_")
                                     and "moment" in v.name)}


def test_row_delta_is_bitwise():
    rng = np.random.RandomState(2)
    base = torch.from_numpy(rng.rand(16, 4).astype("float32"))
    new = base.clone()
    new[3] += 1.0
    new[11, 2] = float(np.nextafter(np.float32(new[11, 2]),
                                    np.float32(np.inf)))
    rows, values = row_delta(base, new)
    assert rows.tolist() == [3, 11] and rows.dtype == torch.int64
    out = base.clone()
    out[rows] = values
    assert torch.equal(out, new)
    base[7, 0] = new[7, 0] = float("nan")
    rows, _ = row_delta(base, new)
    assert 7 not in rows.tolist()
    # bfloat16 rows compare by their bits too
    rows, _ = row_delta(base.to(torch.bfloat16), new.to(torch.bfloat16))
    assert rows.tolist() == [3]
    with pytest.raises(ValueError):
        row_delta(base, new[:3])


def test_sparse_table_state_vars_detects_tables_and_slots():
    _build()
    names = ["table", "table_moment1_0", "table_moment2_0", "fc_w",
             "table_beta1_pow_acc_0", "table_out_w_0", "table_projection"]
    out = sparse_table_state_vars(pt.default_main_program(), names)
    assert out == {"table": V, "table_moment1_0": V, "table_moment2_0": V}


def _train_and_save(root, steps, mgr=None, seed=0, start=1):
    """Train ``steps`` steps, saving after each; (losses, manager, the
    delta vars' final values)."""
    scope, main, startup = pt.Scope(), pt.Program(), pt.Program()
    with pt.scope_guard(scope), pt.unique_name.guard(), \
            pt.program_guard(main, startup):
        loss = _build()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        mgr = mgr or _mgr(root)
        losses = []
        for i, f in enumerate(_batches(steps, seed=seed)):
            losses.append(exe.run(main, feed=f, fetch_list=[loss])[0]
                          .tobytes())
            mgr.save_now(start + i, scope=scope, program=main,
                         executors=exe)
        live = _delta_vars(scope, main)
    return losses, mgr, live


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One 8-step sparse run saved after every step, shared read-only by
    the chain tests (a mutating test copies the directory)."""
    root = tmp_path_factory.mktemp("incr")
    losses, mgr, live = _train_and_save(root, steps=8)
    return {"losses": losses, "dir": str(root / "ck"), "live": live,
            "mgr": mgr}


def _copy_ck(trained, tmp_path):
    dst = str(tmp_path / "ck")
    shutil.copytree(trained["dir"], dst)
    return dst


def test_incremental_cadence_and_bitwise_replay(trained):
    mgr, live = trained["mgr"], trained["live"]
    kinds = {s: "delta" if load_train_state(mgr._step_dir(s)).host.get(
        "incremental") else "full" for s in mgr.all_steps()}
    assert kinds == {1: "full", 2: "delta", 3: "delta", 4: "delta",
                     5: "full", 6: "delta", 7: "delta", 8: "delta"}
    ts4 = load_train_state(mgr._step_dir(4))
    (kind, rows, values), = ts4.delta["table"]
    assert kind == "rows" and 0 < rows.shape[0] < V
    assert tuple(values.shape) == (rows.shape[0], D)
    out = mgr.load(8)
    assert not out.delta
    for n, a in live.items():
        assert torch.equal(out.arrays[n], a), n

    def size(s):
        return sum(os.path.getsize(os.path.join(mgr._step_dir(s), f))
                   for f in os.listdir(mgr._step_dir(s)))

    assert size(4) < size(1)


def test_rotation_keeps_load_bearing_chain(tmp_path):
    _, mgr, live = _train_and_save(tmp_path, steps=6,
                                   mgr=_mgr(tmp_path, max_to_keep=2))
    assert mgr.all_steps() == [5, 6]
    out = mgr.load(6)
    for n, a in live.items():
        assert torch.equal(out.arrays[n], a), n


def test_rotation_never_drops_a_needed_base(tmp_path):
    _, mgr, live = _train_and_save(
        tmp_path, steps=5,
        mgr=_mgr(tmp_path, max_to_keep=2, incremental_full_every=100))
    assert mgr.all_steps() == [1, 2, 3, 4, 5]
    out = mgr.load(5)
    for n, a in live.items():
        assert torch.equal(out.arrays[n], a), n


def test_corrupt_chain_is_loud(trained, tmp_path):
    ck = _copy_ck(trained, tmp_path)
    mgr = TrainStateCheckpointManager(ck, async_save=False,
                                      incremental="auto", max_to_keep=None)
    shutil.rmtree(os.path.join(ck, os.path.basename(
        trained["mgr"]._step_dir(5))))
    with pytest.raises(CheckpointCorruptError):
        mgr.load(8)


def test_restore_seeds_chain_and_next_save_is_delta(trained, tmp_path):
    _copy_ck(trained, tmp_path)
    scope, main, startup = pt.Scope(), pt.Program(), pt.Program()
    with pt.scope_guard(scope), pt.unique_name.guard(), \
            pt.program_guard(main, startup):
        loss = _build()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        mgr2 = _mgr(tmp_path)
        assert mgr2.restore(scope=scope, program=main, executors=exe) == 8
        exe.run(main, feed=_batches(9, seed=0)[8], fetch_list=[loss])
        mgr2.save_now(9, scope=scope, program=main, executors=exe)
        table = scope.find_var("table").clone()
    assert load_train_state(mgr2._step_dir(9)).host.get("incremental")
    assert torch.equal(mgr2.load(9).arrays["table"], table)


def test_exact_resume_from_delta_chain_is_bit_identical(trained, tmp_path):
    """Restored from a delta artifact mid-run, the continued losses and
    table are bit-equal to the uninterrupted run's."""
    ck = _copy_ck(trained, tmp_path)
    assert load_train_state(os.path.join(ck, os.path.basename(
        trained["mgr"]._step_dir(6)))).host.get("incremental")
    scope, main, startup = pt.Scope(), pt.Program(), pt.Program()
    with pt.scope_guard(scope), pt.unique_name.guard(), \
            pt.program_guard(main, startup):
        loss = _build()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        mgr2 = _mgr(tmp_path)
        assert mgr2.restore(scope=scope, program=main, executors=exe,
                            step=6) == 6
        losses = [exe.run(main, feed=f, fetch_list=[loss])[0].tobytes()
                  for f in _batches(8, seed=0)[6:]]
        live = _delta_vars(scope, main)
    assert losses == trained["losses"][6:]
    for n, a in trained["live"].items():
        assert torch.equal(live[n], a), n


def test_delta_chains_replay_across_packages(trained, tmp_path):
    """The JAX manager replays the port's delta chain, and the port's the
    JAX package's, to the same arrays as their writer's own replay."""
    jmgr = _mgr(tmp_path / "j", pkg_ck=jax_ck.TrainStateCheckpointManager)
    scope, main, startup = fluid.Scope(), fluid.Program(), fluid.Program()
    with fluid.scope_guard(scope), fluid.unique_name.guard(), \
            fluid.program_guard(main, startup):
        loss = _build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for i, f in enumerate(_batches(6, seed=1)):
            exe.run(main, feed=f, fetch_list=[loss])
            jmgr.save_now(i + 1, scope=scope, program=main)
    assert load_train_state(jmgr._step_dir(6)).host.get("incremental")
    want = jmgr.load(6).arrays
    got = _mgr(tmp_path / "j").load(6).arrays
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)
    port_dir = _copy_ck(trained, tmp_path)
    jax_view = jax_ck.TrainStateCheckpointManager(
        port_dir, incremental="auto", max_to_keep=None).load(8).arrays
    for n, a in trained["mgr"].load(8).arrays.items():
        np.testing.assert_array_equal(np.asarray(jax_view[n]), a.numpy(),
                                      err_msg=n)


# ---------------------------------------------------------------------------
# the sharded leg
# ---------------------------------------------------------------------------

def _sharded_pair(pkg, ck):
    """Two sharded captures (steps 1 and 2) of the sparse model in
    ``pkg``, the state after step 2 in full, and the delta var names."""
    scope, main, startup = pkg.Scope(), pkg.Program(), pkg.Program()
    with pkg.scope_guard(scope), pkg.unique_name.guard(), \
            pkg.program_guard(main, startup):
        loss = _build(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        feeds = _batches(2)
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        ts1 = ck.capture_train_state(1, scope=scope, program=main,
                                     executors=exe, sharded=True)
        exe.run(main, feed=feeds[1], fetch_list=[loss])
        ts2 = ck.capture_train_state(2, scope=scope, program=main,
                                     executors=exe, sharded=True)
        live = ck.capture_train_state(2, scope=scope, program=main).arrays
        names = ck.sparse_table_state_vars(
            main, [e["name"] for e in ts1.shards])
    return ts1, ts2, live, names


def _write_sharded_chain(mgr, ck, pair, writers=4):
    """Encode both captures over ``writers`` virtual writers and write
    them, each writer's entries grouped by the start of their block (as
    the JAX test does)."""
    ts1, ts2, _, names = pair
    for ts in (ts1, ts2):
        ts.shards = [e for p in ck.partition_shards(ts, writers) for e in p]
        ts._incr_names = names
        mgr._encode_incremental_shards(ts, names)
    for ts in (ts1, ts2):
        by_writer = {}
        for e in ts.shards:
            by_writer.setdefault(int(e["index"][0][0]), []).append(e)
        d = mgr._step_dir(ts.step)
        for w, (_, entries) in enumerate(sorted(by_writer.items())):
            ck.write_train_state_shards(d, ts, w, entries=entries)
        ck.commit_sharded_train_state(d, ts, len(by_writer))


def test_sharded_incremental_writes_local_touched_rows(tmp_path):
    """4 virtual writers each diff only their own block: the table's
    entries become deltas whose rows are global ids inside the writer's
    range, the artifact mixes full and delta entries, and the chain
    replays bit for bit, here and in the JAX package."""
    pair = _sharded_pair(pt, port_ck)
    ts1, ts2, live, _ = pair
    mgr = _mgr(tmp_path)
    _write_sharded_chain(mgr, port_ck, pair)
    table = [e for e in ts2.shards if e["name"] == "table"]
    assert len(table) == 4 and all(e.get("rows") is not None
                                   for e in table)
    for e in table:
        lo, hi = e["index"][0]
        assert all(lo <= r < hi for r in e["rows"].tolist())
    assert any(e.get("rows") is None for e in ts2.shards)
    assert ts2.host["incremental"]["delta_vars"] == [
        "table", "table_moment1_0", "table_moment2_0"]
    delta = load_train_state(mgr._step_dir(2))
    assert {op[0] for op in delta.delta["table"]} == {"rows"}
    out = mgr.load(2)
    assert sorted(out.arrays) == sorted(live)
    for n, a in live.items():
        assert torch.equal(out.arrays[n], a), n
    jax_out = jax_ck.TrainStateCheckpointManager(
        mgr._dir, incremental="auto", max_to_keep=None).load(2).arrays
    for n, a in live.items():
        np.testing.assert_array_equal(np.asarray(jax_out[n]), a.numpy(),
                                      err_msg=n)


def test_jax_sharded_delta_chain_replays_in_port(tmp_path):
    """The JAX package's sharded delta chain (its own test's recipe)
    replays in the port's manager to the JAX live state and the JAX
    manager's own replay."""
    pair = _sharded_pair(fluid, jax_ck)
    live = pair[2]
    jmgr = _mgr(tmp_path, pkg_ck=jax_ck.TrainStateCheckpointManager)
    _write_sharded_chain(jmgr, jax_ck, pair)
    assert jax_ck.load_train_state(jmgr._step_dir(2)).host.get(
        "incremental")
    want = jmgr.load(2).arrays
    got = _mgr(tmp_path).load(2).arrays
    assert sorted(got) == sorted(want) == sorted(live)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]),
                                      err_msg=n)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(live[n]),
                                      err_msg=n)
