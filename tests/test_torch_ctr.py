"""The port's CTR DNN (``models/ctr_dnn.py``) held against the JAX package
on the CPU: the program (``to_dict()``, main and startup), ten Adam steps
from the JAX startup state (loss, streaming AUC, both sparse tables and
the dense parameters) with sequences shorter than the pad width, and the
port alone training to ``tests/test_ctr_dnn.py``'s AUC."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models.ctr_dnn import ctr_dnn as jax_ctr_dnn

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.models.ctr_dnn import ctr_dnn as pt_ctr_dnn
from paddle_tpu_torch.ops.selected_rows import sparse_lookup_tables

from test_torch_serving import fresh_torch_programs  # noqa: F401

DNN_V, LR_V, T, BATCH = 1000, 100, 5, 32


def build(pkg, is_distributed=False, seed=7):
    """``tests/test_ctr_dnn.py``'s program: (main, startup, [cost, auc])."""
    ctr = jax_ctr_dnn if pkg is fluid else pt_ctr_dnn
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        dnn = pkg.layers.data("dnn_ids", shape=[1], dtype="int64",
                              lod_level=1)
        lr = pkg.layers.data("lr_ids", shape=[1], dtype="int64",
                             lod_level=1)
        label = pkg.layers.data("click", shape=[1], dtype="int64")
        cost, _predict, auc = ctr(dnn, lr, label, DNN_V, LR_V,
                                  is_distributed=is_distributed)
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return main, startup, [cost, auc]


def batches(steps, ragged, seed=0):
    """``tests/test_ctr_dnn.py``'s batches: a click when a dnn id falls in
    the hot range [0, 50).  With ``ragged`` each row has 1..T dnn ids and
    1..2 lr ids, the rest of the pad width filled with id 0 (a pad slot
    still names a row, as the JAX package's lookup backward sees it)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(50, DNN_V, (BATCH, T, 1)).astype("int64")
        hot = rng.rand(BATCH) < 0.5
        ids[hot, 0, 0] = rng.randint(0, 50, hot.sum())
        lr_ids = rng.randint(0, LR_V, (BATCH, 2, 1)).astype("int64")
        lens = np.full(BATCH, T, "int64")
        lr_lens = np.full(BATCH, 2, "int64")
        if ragged:
            lens = rng.randint(1, T + 1, BATCH).astype("int64")
            lr_lens = rng.randint(1, 3, BATCH).astype("int64")
            ids[np.arange(T)[None, :] >= lens[:, None]] = 0
            lr_ids[np.arange(2)[None, :] >= lr_lens[:, None]] = 0
        out.append({"dnn_ids": ids, "dnn_ids@LEN": lens, "lr_ids": lr_ids,
                    "lr_ids@LEN": lr_lens,
                    "click": hot.astype("int64").reshape(-1, 1)})
    return out


@pytest.mark.parametrize("is_distributed", [False, True])
def test_ctr_program_serializes_like_jax(is_distributed):
    """Main and startup ``to_dict()`` equal op for op and attr for attr:
    both tables' ``lookup_table_sparse_grad`` with SELECTED_ROWS
    gradients, the ``sequence_pool`` sums, ``concat``, ``auc`` with its
    ``.stat_pos`` / ``.stat_neg`` histograms."""
    jm, js, _ = build(fluid, is_distributed)
    tm, ts, _ = build(pt, is_distributed)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    blk = tm.global_block()
    assert sorted(sparse_lookup_tables(tm)) == sorted(
        ["deep_embedding", "embedding_1.w_0"])
    assert [op.type for op in blk.ops].count("lookup_table_sparse_grad") \
        == 2
    assert blk.var("deep_embedding@GRAD").type == "selected_rows"
    assert blk.var("auc_0.stat_pos").persistable


def test_ctr_ten_steps_follow_jax_with_ragged_ids():
    """Ten Adam steps from the JAX startup state, every row shorter than
    the pad width somewhere: the losses (rtol 1e-4), the streaming AUC
    (atol 1e-4), both tables and every dense parameter and Adam moment
    (rtol 1e-4) follow the JAX package; the pad id's row, touched by the
    pad slots with a zero gradient, moves as the JAX package's does."""
    feeds = batches(10, ragged=True)
    jm, js, jf = build(fluid)
    tm, ts, tf = build(pt)
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    names = [v.name for v in js.list_vars() if v.persistable]
    state = {n: np.array(jscope.find_var(n), copy=True) for n in names}
    tscope = pt.Scope()
    load_numpy_state(tscope, ts, state, "cpu")
    got = {}
    for pkg, main, fetch, scope in ((fluid, jm, jf, jscope),
                                    (pt, tm, tf, tscope)):
        exe = pkg.Executor(pkg.CPUPlace())
        got[pkg] = [[float(np.asarray(v).ravel()[0]) for v in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
    (jl, ja), (tl, ta) = (np.array(got[p]).T for p in (fluid, pt))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(ta, ja, atol=1e-4)
    for n in names:
        if n.endswith((".stat_pos", ".stat_neg")):
            continue
        np.testing.assert_allclose(
            np.asarray(tscope.find_var(n)), np.asarray(jscope.find_var(n)),
            rtol=1e-4, atol=1e-6, err_msg=n)
    row0 = np.asarray(tscope.find_var("deep_embedding"))[0]
    assert not np.array_equal(row0, state["deep_embedding"][0])


def test_ctr_trains_and_auc_rises():
    """``tests/test_ctr_dnn.py::test_ctr_dnn_trains_and_auc_rises`` on the
    port: 120 Adam steps of batch 32, the loss at least halves and the
    streaming AUC ends above 0.85."""
    main, startup, (cost, auc) = build(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    losses, aucs = [], []
    for feed in batches(120, ragged=False):
        lv, av = exe.run(main, feed=feed, fetch_list=[cost, auc],
                         scope=scope)
        losses.append(float(lv[0]))
        aucs.append(float(av[0]))
    assert min(losses[-20:]) < losses[0] * 0.5, (losses[0], losses[-1])
    assert aucs[-1] > 0.85, aucs[-1]


def test_ctr_parallel_trainer_is_refused():
    """``Trainer(parallel=True)`` waits for the mesh runtime (ROADMAP A7)."""
    from paddle_tpu_torch.contrib import Trainer

    with pytest.raises(NotImplementedError, match="A7"):
        Trainer(lambda: build(pt)[2][0], lambda: pt.optimizer.Adam(1e-2),
                place=pt.CPUPlace(), parallel=True)
