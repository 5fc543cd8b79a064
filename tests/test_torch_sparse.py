"""The port's sparse embeddings held against the JAX package on the CPU:
``tests/test_selected_rows.py``'s single-device scenarios (sparse against
dense for SGD and Adagrad, lazy Momentum and Adam, the first step's
sparse update equal to the dense one bit for bit, duplicate rows, one
table used twice, global-norm clipping with L2 decay), ``merge_rows`` /
``to_dense`` against the JAX functions, ``Program.to_dict()`` parity of
the sparse programs, a SelectedRows fetch, the sparse step under bf16
AMP, and no host read on the sparse path.

Both packages build the same program and run the same numpy-seeded
batches, the port from the JAX startup state.  Tolerances between the
packages: rtol 1e-5 on one step, 1e-4 on trajectories; inside the port
the lazy invariants and the first-step equality hold bit for bit.  The
``cuda``-marked test (a captured sparse Adam step against eager, bit for
bit) skips without a card; on the card:
``python -m pytest -m cuda tests/test_torch_sparse.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.contrib import mixed_precision as jax_amp
from paddle_tpu.ops import selected_rows as jax_sr

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import mixed_precision as pt_amp
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import VarType
from paddle_tpu_torch.ops import selected_rows as pt_sr

from test_torch_capture import host_read_guard  # noqa: F401
from test_torch_serving import fresh_torch_programs  # noqa: F401

V, D = 20, 6
ROWS_A = np.array([[[0], [1], [2], [3]]] * 2, "int64")
ROWS_B = np.array([[[10], [11], [12], [13]]] * 2, "int64")
ONES = np.ones((2, 1), "float32")


def tower(pkg, is_sparse, opt, vocab=V, clip=None, reg=None, seed=5):
    """``tests/test_selected_rows.py``'s tower: embedding -> mean pool ->
    fc -> square loss, with an optional global clip and a regularizer on
    the table; returns the loss."""
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    ids = pkg.layers.data("ids", shape=[4, 1], dtype="int64")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    emb = pkg.layers.embedding(
        ids, size=[vocab, D], is_sparse=is_sparse,
        param_attr=pkg.ParamAttr(name="emb_w", regularizer=reg))
    pred = pkg.layers.fc(pkg.layers.reduce_mean(emb, dim=1), size=1,
                         param_attr=pkg.ParamAttr(name="fc_w"),
                         bias_attr=pkg.ParamAttr(name="fc_b"))
    loss = pkg.layers.mean(pkg.layers.square(
        pkg.layers.elementwise_sub(pred, y)))
    if clip is not None:
        pkg.clip.set_gradient_clip(clip(pkg))
    opt(pkg).minimize(loss)
    return loss


def dup_batches(steps, vocab=V, b=8):
    """Seeded batches, each with a guaranteed duplicate row."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (b, 4, 1)).astype("int64")
        ids[0, 0, 0] = ids[0, 1, 0] = 3
        out.append({"ids": ids, "y": rng.rand(b, 1).astype("float32")})
    return out


def _programs(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = build(pkg)
    return main, startup, fetch


def run_both(build, feeds):
    """Build ``build(pkg)`` (returns the fetch vars) in each package: equal
    programs; the JAX startup run, its state carried into the port; the
    feeds run in both.  Returns {"jax"|"port": (per-step fetches, the
    state after each step: {persistable name: array}), "init": the
    startup state}."""
    jm, js, jf = _programs(fluid, build)
    tm, ts, tf = _programs(pt, build)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    names = [v.name for v in js.list_vars() if v.persistable]
    state = {n: np.array(jscope.find_var(n), copy=True) for n in names}
    tscope = pt.Scope()
    load_numpy_state(tscope, ts, state, "cpu")
    out = {"init": state}
    for key, pkg, main, fetch, scope in (("jax", fluid, jm, jf, jscope),
                                         ("port", pt, tm, tf, tscope)):
        exe = pkg.Executor(pkg.CPUPlace())
        fetches, states = [], []
        for f in feeds:
            fetches.append([np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=fetch, scope=scope)])
            states.append({n: np.array(np.asarray(scope.find_var(n)),
                                       copy=True) for n in names})
        out[key] = (fetches, states)
    return out


def assert_port_follows_jax(out, rtol):
    """Every fetch and every persistable after every step, port vs JAX
    (atol: 1e-6 of values of order 1)."""
    (jf, js), (tf, ts) = out["jax"], out["port"]
    for a, b in zip(jf, tf):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-6)
    for a, b in zip(js, ts):
        for n in a:
            np.testing.assert_allclose(b[n], a[n], rtol=rtol, atol=1e-6,
                                       err_msg=n)


def _losses(out, key="port"):
    return [float(f[0].ravel()[0]) for f in out[key][0]]


SGD = lambda pkg: pkg.optimizer.SGD(learning_rate=0.1)  # noqa: E731
ADAGRAD = lambda pkg: pkg.optimizer.Adagrad(learning_rate=0.1)  # noqa: E731
ADAM = lambda pkg: pkg.optimizer.Adam(learning_rate=0.1)  # noqa: E731
MOMENTUM = lambda pkg: pkg.optimizer.Momentum(  # noqa: E731
    learning_rate=0.1, momentum=0.9)


@pytest.mark.parametrize("opt", [SGD, ADAGRAD], ids=["sgd", "adagrad"])
def test_sparse_matches_dense(opt):
    """For SGD and Adagrad a zero dense gradient row is a no-op, so the
    lazy sparse update follows the dense one (rtol 1e-4: sparse SGD adds
    duplicates one by one); each path follows the JAX package's over 8
    steps (rtol 1e-4)."""
    outs = {}
    for sparse in (True, False):
        outs[sparse] = run_both(
            lambda pkg, s=sparse: [tower(pkg, s, opt)], dup_batches(8))
        assert_port_follows_jax(outs[sparse], rtol=1e-4)
    np.testing.assert_allclose(_losses(outs[True]), _losses(outs[False]),
                               rtol=1e-4)
    np.testing.assert_allclose(outs[True]["port"][1][-1]["emb_w"],
                               outs[False]["port"][1][-1]["emb_w"],
                               rtol=1e-4, atol=1e-6)


def _row_slots(state, table="emb_w"):
    return [n for n in state if pt_sr.is_row_slot_of(n, table)]


@pytest.mark.parametrize("opt", [MOMENTUM, ADAM], ids=["momentum", "adam"])
def test_sparse_update_is_lazy(opt):
    """Rows 0-3, then rows 10-13: a row the second step does not touch
    keeps its parameter and every row-slot accumulator bit for bit, the
    touched rows and their slots move, and each step follows the JAX
    package's (rtol 1e-5)."""
    out = run_both(lambda pkg: [tower(pkg, True, opt)],
                   [{"ids": ROWS_A, "y": ONES}, {"ids": ROWS_B, "y": ONES}])
    assert_port_follows_jax(out, rtol=1e-5)
    s1, s2 = out["port"][1]
    slots = _row_slots(s1)
    assert slots
    untouched = list(range(4)) + list(range(14, V))
    for n in ["emb_w"] + slots:
        np.testing.assert_array_equal(s1[n][untouched], s2[n][untouched])
        assert np.abs(s2[n][10:14] - s1[n][10:14]).sum() > 0, n


@pytest.mark.parametrize("opt", [ADAM, ADAGRAD], ids=["adam", "adagrad"])
def test_sparse_update_bitwise_matches_dense_first_step(opt):
    """One step from one state, a duplicate row in the batch: the sparse
    table and every slot var are the dense path's bits (merge_rows sums
    duplicates as the dense backward does); each follows JAX at rtol
    1e-5."""
    feeds = dup_batches(1)
    sparse = run_both(lambda pkg: [tower(pkg, True, opt)], feeds)
    dense = run_both(lambda pkg: [tower(pkg, False, opt)], feeds)
    for out in (sparse, dense):
        assert_port_follows_jax(out, rtol=1e-5)
    a, b = sparse["port"][1][0], dense["port"][1][0]
    assert _row_slots(a) and set(a) == set(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.mark.parametrize("padding_idx", [None, 5])
def test_sparse_grad_densifies_to_dense_grad(padding_idx):
    """``get_tensor_from_selected_rows`` of the lookup's gradient, with
    duplicate rows, against a hand sum and against the JAX package; with
    ``padding_idx`` the pad id's rows look up zeros and get no gradient."""
    def build(pkg):
        ids = pkg.layers.data("ids", shape=[3, 1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[V, D], is_sparse=True,
                                   padding_idx=padding_idx,
                                   param_attr=pkg.ParamAttr(name="w_sp"))
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(emb, emb))
        pkg.backward.append_backward(loss)
        blk = pkg.default_main_program().global_block()
        g = blk.create_var(name="dense_of_sparse", shape=[V, D],
                           dtype="float32")
        blk.append_op(type="get_tensor_from_selected_rows",
                      inputs={"X": ["w_sp@GRAD"]}, outputs={"Out": [g]})
        return [g]

    idv = np.random.RandomState(1).randint(0, V, (4, 3, 1)).astype("int64")
    idv[0, 0, 0] = idv[0, 1, 0] = 5
    out = run_both(build, [{"ids": idv}])
    assert_port_follows_jax(out, rtol=1e-5)
    w = out["port"][1][0]["w_sp"]
    ref = np.zeros((V, D), "float32")
    for i in idv.reshape(-1):
        if i != padding_idx:
            ref[i] += 2.0 * w[i]
    np.testing.assert_allclose(out["port"][0][0][0], ref, rtol=1e-5)
    assert not ref[5].any() if padding_idx == 5 else ref[5].any()


def test_embedding_used_twice_accumulates():
    """Two lookups of one table: the contributions concatenate into one
    SELECTED_ROWS gradient, and SGD moves each row by its count."""
    def build(pkg):
        a = pkg.layers.data("a", shape=[2, 1], dtype="int64")
        b = pkg.layers.data("b", shape=[2, 1], dtype="int64")
        ea = pkg.layers.embedding(a, size=[V, D], is_sparse=True,
                                  param_attr=pkg.ParamAttr(name="w2"))
        eb = pkg.layers.embedding(b, size=[V, D], is_sparse=True,
                                  param_attr=pkg.ParamAttr(name="w2"))
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_add(ea, eb))
        pkg.optimizer.SGD(learning_rate=1.0).minimize(loss)
        return [loss]

    tm, _, _ = _programs(pt, build)
    blk = tm.global_block()
    (sgd,) = [op for op in blk.ops if op.type == "sgd"]
    assert blk.var(sgd.inputs["Grad"][0]).type == VarType.SELECTED_ROWS
    assert [op.type for op in blk.ops].count("sum") == 1
    out = run_both(build, [{"a": np.array([[[1], [2]]], "int64"),
                            "b": np.array([[[2], [3]]], "int64")}])
    assert_port_follows_jax(out, rtol=1e-5)
    delta = out["init"]["w2"] - out["port"][1][0]["w2"]
    np.testing.assert_allclose(delta[[0, 1, 2, 3]],
                               np.repeat([[0.], [1.], [2.], [1.]], D, 1),
                               atol=1e-6)


GLOBAL_CLIP = lambda pkg: pkg.clip.GradientClipByGlobalNorm(  # noqa: E731
    clip_norm=0.5)


def test_sparse_grad_survives_global_clip_and_decay():
    """Global-norm clip + L2 decay on an ``is_sparse`` table: (a) the
    optimizer's gradient var stays SELECTED_ROWS and rows never touched
    keep their bits across steps; (b) under the clip, sparse Adagrad
    follows dense Adagrad over 3 steps (rtol 1e-4); (c) on the first step
    the decayed touched rows match the dense regularized update (rtol
    1e-6) while the dense path also moves the untouched rows.  Every run
    follows the JAX package's."""
    reg = lambda pkg: pkg.regularizer.L2Decay(1e-3)  # noqa: E731
    tm, _, _ = _programs(pt, lambda pkg: [tower(
        pkg, True, ADAM, clip=GLOBAL_CLIP, reg=reg(pkg))])
    blk = tm.global_block()
    (adam,) = [op for op in blk.ops if op.type == "adam"
               and op.inputs["Param"][0] == "emb_w"]
    assert blk.var(adam.inputs["Grad"][0]).type == VarType.SELECTED_ROWS

    lazy = run_both(lambda pkg: [tower(pkg, True, ADAM, clip=GLOBAL_CLIP,
                                       reg=reg(pkg))],
                    [{"ids": ROWS_A, "y": ONES}, {"ids": ROWS_B, "y": ONES}])
    assert_port_follows_jax(lazy, rtol=1e-5)
    s1, s2 = lazy["port"][1]
    np.testing.assert_array_equal(s1["emb_w"][4:10], s2["emb_w"][4:10])

    traj = {s: run_both(lambda pkg, s=s: [tower(pkg, s, ADAGRAD,
                                                clip=GLOBAL_CLIP)],
                        dup_batches(3)) for s in (True, False)}
    for out in traj.values():
        assert_port_follows_jax(out, rtol=1e-4)
    np.testing.assert_allclose(_losses(traj[True]), _losses(traj[False]),
                               rtol=1e-4)
    np.testing.assert_allclose(traj[True]["port"][1][-1]["emb_w"],
                               traj[False]["port"][1][-1]["emb_w"],
                               rtol=1e-4, atol=1e-6)

    feeds = dup_batches(1)
    touched = sorted(set(feeds[0]["ids"].ravel().tolist()))
    untouched = [r for r in range(V) if r not in touched]
    first = {s: run_both(lambda pkg, s=s: [tower(pkg, s, ADAM,
                                                 reg=reg(pkg))], feeds)
             for s in (True, False)}
    for out in first.values():
        assert_port_follows_jax(out, rtol=1e-5)
    w_sp, w_dn = (first[s]["port"][1][0]["emb_w"] for s in (True, False))
    np.testing.assert_allclose(w_sp[touched], w_dn[touched], rtol=1e-6,
                               atol=1e-7)
    assert np.abs(w_dn[untouched] - w_sp[untouched]).max() > 0


@pytest.mark.parametrize("clip,reg", [
    ("value", "l1"), ("norm", "l2"), ("global", "l2"), ("global", None),
    ("error", None)])
def test_sparse_programs_serialize_like_jax(clip, reg):
    """bench.py's ``rec_sparse`` program (reduce_sum pool, fc 32 relu, fc
    1, square loss, Adam) with each clip and decay: ``to_dict()`` equal op
    for op, attr for attr, var types included; one step follows JAX."""
    def build(pkg):
        pkg.default_main_program().random_seed = 11
        pkg.default_startup_program().random_seed = 11
        ids = pkg.layers.data("ids", shape=[16, 1], dtype="int64")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        regs = {"l1": pkg.regularizer.L1Decay(1e-3),
                "l2": pkg.regularizer.L2Decay(1e-3), None: None}
        clips = {"value": pkg.clip.GradientClipByValue(0.01, min=0.001),
                 "norm": pkg.clip.GradientClipByNorm(0.05),
                 "global": pkg.clip.GradientClipByGlobalNorm(0.5)}
        emb = pkg.layers.embedding(
            ids, size=[50, 16], is_sparse=True,
            param_attr=pkg.ParamAttr(name="table", regularizer=regs[reg],
                                     gradient_clip=clips.get(clip)))
        if clip == "error":
            emb.error_clip = pkg.clip.ErrorClipByValue(0.01)
        x = pkg.layers.fc(pkg.layers.reduce_sum(emb, dim=1), size=32,
                          act="relu")
        pred = pkg.layers.fc(x, size=1)
        loss = pkg.layers.mean(pkg.layers.square(
            pkg.layers.elementwise_sub(pred, y)))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return [loss]

    rng = np.random.RandomState(3)
    out = run_both(build, [{"ids": rng.randint(0, 50, (8, 16, 1)),
                            "y": rng.rand(8, 1).astype("float32")}])
    assert_port_follows_jax(out, rtol=1e-5)
    tm, _, _ = _programs(pt, build)
    types = {v.name: v.type for v in tm.global_block().vars.values()}
    assert types["table@GRAD"] == VarType.SELECTED_ROWS


MERGE_CASES = {
    "duplicates": ([4, 1, 4, 0, 1, 4], 6),
    "sentinels": ([2, 6, 0, 6, 2, 5], 6),
    "all_unique": ([3, 0, 5, 1], 6),
    "single": ([2], 6),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_rows_and_to_dense_match_jax(case):
    """Unique rows ascending then the sentinel, the merged values, the
    valid mask, and the dense tensor, against the JAX functions (rows
    exact; values rtol 1e-6)."""
    rows, height = MERGE_CASES[case]
    vals = np.random.RandomState(0).randn(len(rows), 3).astype("float32")
    jsr = jax_sr.SelectedRows(jnp.asarray(rows, jnp.int32),
                              jnp.asarray(vals), height)
    tsr = pt_sr.SelectedRows(torch.tensor(rows), torch.from_numpy(vals),
                             height)
    for want, got in zip(jax_sr.merge_rows(jsr), pt_sr.merge_rows(tsr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)
    np.testing.assert_allclose(pt_sr.to_dense(tsr).numpy(),
                               np.asarray(jax_sr.to_dense(jsr)), rtol=1e-6)
    np.testing.assert_allclose(float(pt_sr.merged_sumsq(tsr)),
                               float(jax_sr.merged_sumsq(jsr)), rtol=1e-6)


def test_sentinel_slots_leave_real_rows_bits():
    """A merged SelectedRows with sentinel slots (row 3 of a 3-row table):
    the accumulating and the writing scatter change only the touched row
    and leave the others' bits as they were, -0.0 in row 0 included."""
    table = torch.tensor([[-0.0, 1.0], [2.0, -0.0], [3.0, 4.0]])
    uniq = torch.tensor([1, 3, 3])
    added = pt_sr.scatter_add_rows(
        table.clone(), uniq, torch.tensor([[1.0, 1.0], [0.0, 0.0],
                                           [0.0, 0.0]]))
    written = pt_sr.scatter_update_rows(
        table.clone(), uniq, uniq < 3,
        torch.tensor([[7.0, 8.0], [0.0, 0.0], [0.0, 0.0]]))
    for got, row1 in ((added, [3.0, 1.0]), (written, [7.0, 8.0])):
        np.testing.assert_array_equal(got[1].numpy(), row1)
        for r in (0, 2):
            assert np.array_equal(got[r].numpy().view(np.int32),
                                  table[r].numpy().view(np.int32))


def test_selected_rows_fetch_comes_back_like_jax():
    """A fetch of the sparse gradient: a 0-d object array holding the
    SelectedRows (numpy rows and values), as the JAX executor returns it;
    ``return_numpy=False`` gives the SelectedRows itself."""
    def build(pkg):
        ids = pkg.layers.data("ids", shape=[3, 1], dtype="int64")
        e = pkg.layers.embedding(ids, size=[10, 4], is_sparse=True,
                                 param_attr=pkg.ParamAttr(name="w"))
        pkg.backward.append_backward(pkg.layers.reduce_sum(e))
        return ["w@GRAD"]

    feed = {"ids": np.array([[[1], [4], [1]], [[0], [9], [4]]], "int64")}
    got = {}
    for pkg in (fluid, pt):
        main, startup, fetch = _programs(pkg, build)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        (a,) = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        (b,) = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
        assert a.shape == () and a.dtype == object
        got[pkg] = (a[()], b)
    for (a, b), (c, d) in [(got[fluid], got[pt])]:
        assert isinstance(c, pt_sr.SelectedRows) and c.height == a.height
        assert isinstance(d, pt_sr.SelectedRows)
        np.testing.assert_array_equal(c.rows, np.asarray(a.rows))
        np.testing.assert_array_equal(c.values, np.asarray(a.values))
        np.testing.assert_array_equal(d.rows.numpy(), c.rows)


def test_sparse_step_under_amp_matches_jax():
    """The tower under ``decorate`` with an ``is_sparse`` table: the
    SelectedRows passes the AMP cast untouched in both packages, its
    values take the dtype the JAX package gives them, and one Adam step
    follows JAX within the AMP band (loss rtol 1e-2, state rtol 1e-2 atol
    1e-3)."""
    def build(pkg, amp):
        return lambda p: [tower(p, True, lambda q: amp.decorate(
            q.optimizer.Adam(learning_rate=0.1))), "emb_w@GRAD"]

    feeds = dup_batches(1)
    jm, js, jf = _programs(fluid, build(fluid, jax_amp))
    tm, ts, tf = _programs(pt, build(pt, pt_amp))
    assert tm.to_dict() == jm.to_dict()
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(js, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name), copy=True)
             for v in js.list_vars() if v.persistable}
    tscope = pt.Scope()
    load_numpy_state(tscope, ts, state, "cpu")
    jl, jg = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed=feeds[0], fetch_list=jf, scope=jscope, return_numpy=False)
    tl, tg = pt.Executor(pt.CPUPlace()).run(
        tm, feed=feeds[0], fetch_list=tf, scope=tscope, return_numpy=False)
    assert isinstance(tg, pt_sr.SelectedRows)
    assert str(tg.values.dtype).split(".")[-1] == str(jg.values.dtype)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-2)
    for n in state:
        np.testing.assert_allclose(
            np.asarray(tscope.find_var(n).float()),
            np.asarray(jscope.find_var(n), np.float32), rtol=1e-2,
            atol=1e-3, err_msg=n)


def test_sparse_step_reads_nothing_on_the_host(host_read_guard):
    """Two sparse Adam steps under global-norm clip and L2 decay: no op
    reads a value on the host (so the step captures in a CUDA graph)."""
    main, startup, loss = _programs(pt, lambda pkg: tower(
        pkg, True, ADAM, clip=GLOBAL_CLIP,
        reg=pkg.regularizer.L2Decay(1e-3)))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    del host_read_guard[:]
    for f in dup_batches(2):
        (out,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    assert host_read_guard == []


@pytest.fixture
def card():
    """The CUDA place; the test skips on a machine without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return pt.CUDAPlace(0)


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True])
def test_captured_sparse_adam_matches_eager_bits(card, deterministic):
    """Four sparse Adam steps (global-norm clip, L2 decay, duplicate rows)
    captured (the first eager, the second captured) against four eager
    ones from one startup state: the losses and every scope tensor are the
    same bits, and the captured executor holds one graph; also under
    ``torch.use_deterministic_algorithms`` (no op of the sparse path may
    raise there, as the ResNet phases run)."""
    main, startup, loss = _programs(pt, lambda pkg: tower(
        pkg, True, ADAM, vocab=1000, clip=GLOBAL_CLIP,
        reg=pkg.regularizer.L2Decay(1e-3)))
    start = pt.Scope()
    pt.Executor(card).run(startup, scope=start)
    runs = {}
    torch.use_deterministic_algorithms(deterministic)
    try:
        for capture in (False, True):
            scope = pt.Scope()
            for n in start.local_var_names():
                scope.set_var(n, start.find_var(n).clone())
            exe = pt.Executor(card, capture=capture)
            losses = [exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0]
                      for f in dup_batches(4, vocab=1000)]
            runs[capture] = (losses, scope, exe)
    finally:
        torch.use_deterministic_algorithms(False)
    (le, se, _), (lc, sc, exe) = runs[False], runs[True]
    assert all(np.array_equal(a, b) for a, b in zip(le, lc))
    for n in se.local_var_names():
        assert torch.equal(se.find_var(n), sc.find_var(n)), n
    assert sum(s.graph is not None for s in exe._steps.values()) == 1
