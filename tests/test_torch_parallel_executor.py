"""The mesh runtime's ``ParallelExecutor`` on the CPU, against the JAX
package's and against the port's own single-device run.

The port runs as a world of 4 gloo ranks (``torch_mesh_world``: each
rank ``python tests/test_torch_parallel_executor.py --rank R ...``, a
``FileStore`` under the module's tmp dir), every case of the module in
one world; the JAX ``ParallelExecutor`` runs in this process on
conftest's 8-device virtual mesh at the same mesh shape.  Both start
from the JAX startup program's state (``convert.load_numpy_state``) and
take the same seeded batches (each port rank keeps its rows).  Bands:
the JAX tests' 1e-4 on loss trajectories; the single-device parity
tests' on state.

The counterparts of ``tests/test_parallel_executor.py``'s tests (not the
graft dry run), the sharded cases of ``tests/test_selected_rows.py``
(``:188``, ``:209``, ``:475``, ``:564``) and ``tests/test_ctr_dnn.py:64``;
then a dropout-0.1 Transformer over dp x tp equal to the port's
single-device run, and a world of one bit-equal to ``Executor``.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_world import error_of, run_world  # noqa: E402

WORLD = 4
V, D = 20, 6


# ---------------------------------------------------------------------------
# models, generic over the package (``fluid`` or the port)
# ---------------------------------------------------------------------------

def _build_mlp(pkg, seed=7):
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    img = pkg.layers.data("img", shape=[32])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(img, size=64, act="relu")
    pred = pkg.layers.fc(h, size=8, act=None)
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(pred, label))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _data(steps=6, batch=16):
    rng = np.random.RandomState(0)
    proj = rng.rand(32, 8).astype("float32")
    out = []
    for _ in range(steps):
        x = rng.rand(batch, 32).astype("float32")
        y = (x @ proj).argmax(1).astype("int64").reshape(-1, 1)
        out.append({"img": x, "label": y})
    return out


def _uneven_data():
    return _data(steps=5) + _data(steps=1, batch=9)   # 9 % 4 != 0


def _build_sr(pkg, is_sparse, opt, seed=13):
    """``tests/test_selected_rows.py``'s ``_build``."""
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    ids = pkg.layers.data("ids", shape=[4, 1], dtype="int64")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    emb = pkg.layers.embedding(ids, size=[V, D], is_sparse=is_sparse,
                               param_attr=pkg.ParamAttr(name="emb_w"))
    pred = pkg.layers.fc(pkg.layers.reduce_mean(emb, dim=1), size=1,
                         param_attr=pkg.ParamAttr(name="fc_w"),
                         bias_attr=pkg.ParamAttr(name="fc_b"))
    loss = pkg.layers.mean(pkg.layers.square(
        pkg.layers.elementwise_sub(pred, y)))
    opt(pkg).minimize(loss)
    return loss


def _sr_batches(steps=8, b=8):
    rng = np.random.RandomState(0)
    return [{"ids": rng.randint(0, V, (b, 4, 1)).astype("int64"),
             "y": rng.rand(b, 1).astype("float32")} for _ in range(steps)]


def _build_dist_tower(pkg, vocab, seed=5):
    """``tests/test_selected_rows.py``'s ``_build_dist_tower`` (Adam)."""
    pkg.default_main_program().random_seed = seed
    pkg.default_startup_program().random_seed = seed
    ids = pkg.layers.data("ids", shape=[4, 1], dtype="int64")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    emb = pkg.layers.embedding(ids, size=[vocab, D], is_sparse=True,
                               is_distributed=True,
                               param_attr=pkg.ParamAttr(name="emb_w"))
    pred = pkg.layers.fc(pkg.layers.reduce_mean(emb, dim=1), size=1,
                         param_attr=pkg.ParamAttr(name="fc_w"),
                         bias_attr=pkg.ParamAttr(name="fc_b"))
    loss = pkg.layers.mean(pkg.layers.square(
        pkg.layers.elementwise_sub(pred, y)))
    pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return loss


def _dup_batches(vocab, steps=2, b=8):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (b, 4, 1)).astype("int64")
        ids[0, 0, 0] = ids[0, 1, 0] = 3      # a duplicate row
        out.append({"ids": ids, "y": rng.rand(b, 1).astype("float32")})
    return out


CTR_DNN_V, CTR_LR_V, CTR_T, CTR_BATCH = 1000, 100, 5, 32


def _build_ctr(pkg, is_distributed):
    """``tests/test_ctr_dnn.py``'s program: the cost."""
    if pkg.__name__ == "paddle_tpu":
        from paddle_tpu.models.ctr_dnn import ctr_dnn
    else:
        from paddle_tpu_torch.models.ctr_dnn import ctr_dnn
    pkg.default_main_program().random_seed = 7
    pkg.default_startup_program().random_seed = 7
    dnn = pkg.layers.data("dnn_ids", shape=[1], dtype="int64", lod_level=1)
    lr = pkg.layers.data("lr_ids", shape=[1], dtype="int64", lod_level=1)
    label = pkg.layers.data("click", shape=[1], dtype="int64")
    cost, _p, _a = ctr_dnn(dnn, lr, label, CTR_DNN_V, CTR_LR_V,
                           is_distributed=is_distributed)
    pkg.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return cost


def _ctr_batches(steps):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        ids = rng.randint(50, CTR_DNN_V, (CTR_BATCH, CTR_T, 1)).astype(
            "int64")
        hot = rng.rand(CTR_BATCH) < 0.5
        ids[hot, 0, 0] = rng.randint(0, 50, hot.sum())
        out.append({"dnn_ids": ids,
                    "dnn_ids@LEN": np.full(CTR_BATCH, CTR_T, "int64"),
                    "lr_ids": rng.randint(0, CTR_LR_V, (CTR_BATCH, 2, 1))
                    .astype("int64"),
                    "lr_ids@LEN": np.full(CTR_BATCH, 2, "int64"),
                    "click": hot.astype("int64").reshape(-1, 1)})
    return out


TFM = dict(t=8, vocab=32)


def _build_tfm(pkg, dropout):
    if pkg.__name__ == "paddle_tpu":
        from paddle_tpu.models import transformer as tfm
    else:
        from paddle_tpu_torch.models import transformer as tfm
    pkg.default_main_program().random_seed = 11
    pkg.default_startup_program().random_seed = 11
    words = [pkg.layers.data(n, shape=[1], dtype="int64", lod_level=1)
             for n in ("src_word", "tgt_word", "lbl_word")]
    cost, _ = tfm.transformer(*words, TFM["t"], TFM["t"], TFM["vocab"],
                              TFM["vocab"], n_layer=1, n_head=2, d_model=16,
                              d_inner=32, dropout_rate=dropout)
    pkg.optimizer.Adam(learning_rate=2e-3).minimize(cost)
    return cost


def _tfm_batches(steps=3, batch=8):
    t, vocab = TFM["t"], TFM["vocab"]
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        ids = rng.randint(2, vocab, (batch, t, 1)).astype("int64")
        lens = rng.randint(t // 2, t + 1, (batch,)).astype("int32")
        out.append({"src_word": ids, "src_word@LEN": lens,
                    "tgt_word": ids, "tgt_word@LEN": lens,
                    "lbl_word": ids, "lbl_word@LEN": lens})
    return out


# ---------------------------------------------------------------------------
# the ranks' cases (run in the world; no JAX in a rank)
# ---------------------------------------------------------------------------

def _state_in(inputs):
    return {k[2:]: v for k, v in inputs.items() if k.startswith("S:")}


def _start(pt, inputs):
    from paddle_tpu_torch.convert import load_numpy_state

    load_numpy_state(pt.global_scope(), pt.default_startup_program(),
                     _state_in(inputs), "cpu")


def _pe(pt, loss, mesh, bs=None, **kw):
    return pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                               mesh=mesh, build_strategy=bs, **kw)


def _losses(pe, loss, feeds):
    return np.array([float(np.asarray(pe.run([loss], feed=f)[0]).ravel()[0])
                     for f in feeds])


def case_mlp_dp(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    return {"losses": _losses(_pe(pt, loss, pt.make_mesh((world,))), loss,
                              _data())}


def case_mlp_kreduce(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
    pe = _pe(pt, loss, pt.make_mesh((world,)), bs)
    out = {"losses": _losses(pe, loss, _data())}
    w = pt.global_scope().var("fc_0.w_0")
    out["w_local_shape"] = np.array(w.shape)
    out["w_spec"] = np.array(str(pe.state_shardings()["fc_0.w_0"].spec))
    return out


def case_mlp_dptp(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pe = _pe(pt, loss, pt.make_mesh((world // 2, 2), ("dp", "tp")))
    return {"losses": _losses(pe, loss, _data(batch=8))}


def case_mlp_feedlist(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    b = _data(steps=1, batch=16)[0]
    split = [{k: v[i * 4:(i + 1) * 4] for k, v in b.items()}
             for i in range(world)]
    pe = _pe(pt, loss, pt.make_mesh((world,)))
    (merged,) = pe.run([loss], feed=split)
    return {"loss": np.asarray(merged)}


def case_mlp_uneven(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pe = _pe(pt, loss, pt.make_mesh((world,)))
    return {"losses": _losses(pe, loss, _uneven_data()),
            "padded": np.array(pe.uneven_batches_padded)}


def case_mlp_uneven_trim(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pred = next(op.inputs["Logits"][0]
                for op in pt.default_main_program().global_block().ops
                if op.type == "softmax_with_cross_entropy")
    pe = _pe(pt, loss, pt.make_mesh((world,)))
    logits, l = pe.run([pred, loss], feed=_data(steps=1, batch=9)[0])
    return {"logits": np.asarray(logits), "loss": np.asarray(l),
            "padded": np.array(pe.uneven_batches_padded)}


def case_mlp_reject(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.pad_uneven_batches = False
    pe = _pe(pt, loss, pt.make_mesh((world,)), bs)
    pe.run([loss], feed=_data(steps=1, batch=9)[0])
    return {}


def _tp_spec(name, shape):
    from paddle_tpu_torch.parallel import PartitionSpec as P

    if len(shape) == 2 and shape[1] % 2 == 0:
        return P(None, "tp")
    return None


def case_mlp_tp_policy(inputs, rank, world):
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.param_sharding_fn = _tp_spec
    pe = _pe(pt, loss, pt.make_mesh((world // 2, 2), ("dp", "tp")), bs)
    out = {"losses": _losses(pe, loss, _data(batch=8))}
    out["w_local_shape"] = np.array(pt.global_scope().var("fc_0.w_0").shape)
    return out


def case_mlp_bad_policy(inputs, rank, world):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import PartitionSpec as P

    loss = _build_mlp(pt)
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.param_sharding_fn = lambda name, shape: (
        P(("dp", "tp")) if len(shape) == 1 and shape[0] % 16 != 0 else None)
    pe = _pe(pt, loss, pt.make_mesh((world // 2, 2), ("dp", "tp")), bs)
    pe.run([loss], feed=_data(steps=1, batch=8)[0])
    return {}


def case_mesh_shapes(inputs, rank, world):
    import paddle_tpu_torch as pt

    m = pt.make_mesh()
    m2 = pt.make_mesh((2, 1, 2), ("dp", "tp", "sp"))
    out = {"size": np.array(m.size), "names": np.array(m2.axis_names),
           "coords": np.array([m2.coords(rank)[a] for a in m2.axis_names])}
    try:
        pt.make_mesh((16, 16))
        out["too_big"] = np.array("")
    except ValueError as e:
        out["too_big"] = np.array(str(e))
    return out


def case_emb_dp_parity(inputs, rank, world):
    """``test_sharded_embedding_parallel_parity``: the table row-sharded
    over dp (gathered at use: dp also splits the batch)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import PartitionSpec as P

    loss = _build_sr(pt, True, lambda pkg: pkg.optimizer.SGD(0.1))
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.param_sharding_fn = lambda name, shape: (
        P("dp") if name == "emb_w" and shape and shape[0] % world == 0
        else None)
    pe = _pe(pt, loss, pt.make_mesh((world,)), bs)
    losses = _losses(pe, loss, _sr_batches())
    full = pe.gathered_state({"emb_w": pt.global_scope().var("emb_w")})
    return {"losses": losses, "emb_w": full["emb_w"].numpy(),
            "local_rows": np.array(pt.global_scope().var("emb_w").shape[0])}


def case_emb_rowshard(inputs, rank, world):
    """``test_rowsharded_pe_sparse_update_engages_and_matches``: dp x ep,
    the table and its Adam moments row-sharded over ep, the lookup and
    the lazy update through ``parallel.embedding``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import embedding as emb_mod

    calls = {"lookup": 0, "update": 0}
    lookup, update = emb_mod.sharded_sparse_lookup, \
        emb_mod.sharded_sparse_update

    def spy_lookup(*a, **kw):
        out = lookup(*a, **kw)
        calls["lookup"] += out is not None
        return out

    def spy_update(ctx, attrs, g):
        out = update(ctx, attrs, g)
        calls["update"] += out is not g
        return out

    emb_mod.sharded_sparse_lookup = spy_lookup
    emb_mod.sharded_sparse_update = spy_update
    loss = _build_dist_tower(pt, V)
    _start(pt, inputs)
    mesh = pt.make_mesh((world // 2, 2), ("dp", "ep"))
    bs = pt.BuildStrategy()
    bs.param_sharding_fn = emb_mod.distributed_embedding_sharding_fn(
        pt.default_main_program(), mesh)
    pe = _pe(pt, loss, mesh, bs)
    scope = pt.global_scope()
    losses, stable = [], True
    prev = None
    for f in _dup_batches(V, steps=3):
        losses.append(float(pe.run([loss], feed=f)[0].ravel()[0]))
        now = pe.gathered_state({"emb_w": scope.var("emb_w")})["emb_w"] \
            .numpy().copy()
        if prev is not None:
            keep = [r for r in range(V)
                    if r not in set(f["ids"].ravel().tolist())]
            stable = stable and bool(np.array_equal(prev[keep], now[keep]))
        prev = now
    moments = sorted(n for n in scope.local_var_names()
                     if n.startswith("emb_w_") and "moment" in n)
    return {"losses": np.array(losses), "emb_w": prev,
            "stable": np.array(stable),
            "calls": np.array([calls["lookup"], calls["update"]]),
            "moment_rows": np.array([scope.var(n).shape[0]
                                     for n in moments]),
            "specs": np.array([str(pe.state_shardings()[n].spec)
                               for n in ["emb_w"] + moments])}


def case_emb_no_dense(inputs, rank, world):
    """``test_mesh_sharded_sparse_never_materializes_dense_table_grad``:
    no rank gathers the row-sharded table or builds a dense [vocab, D]
    gradient of it (``to_dense`` counted, the plan's gathers listed), and
    the state it holds is its 1/ep share."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import selected_rows
    from paddle_tpu_torch.parallel import embedding as emb_mod

    dense = [0]
    to_dense = selected_rows.to_dense

    def spy(sr):
        dense[0] += 1
        return to_dense(sr)

    selected_rows.to_dense = spy
    vocab = 4096
    loss = _build_dist_tower(pt, vocab)
    _start(pt, inputs)
    mesh = pt.make_mesh((world // 2, 2), ("dp", "ep"))
    bs = pt.BuildStrategy()
    bs.param_sharding_fn = emb_mod.distributed_embedding_sharding_fn(
        pt.default_main_program(), mesh)
    pe = _pe(pt, loss, mesh, bs)
    pe.run([loss], feed=_dup_batches(vocab, steps=1)[0])
    plan = next(iter(pe._plans.values()))
    gathers = [op.inputs["X"][0] for op in plan.program.global_block().ops
               if op.type in ("c_reshard", "c_allgather")]
    scope = pt.global_scope()
    table = [n for n in scope.local_var_names()
             if n == "emb_w" or n.startswith("emb_w_moment")]
    return {"to_dense": np.array(dense[0]),
            "table_gathers": np.array([g for g in gathers
                                       if g.startswith("emb_w")] or [""]),
            "table_bytes": np.array(sum(scope.var(n).numel() * 4
                                        for n in table))}


def case_ctr_ep(inputs, rank, world):
    """``tests/test_ctr_dnn.py:64``: the is_distributed tables row-sharded
    over ep by the transpiler's plan."""
    import paddle_tpu_torch as pt

    cost = _build_ctr(pt, True)
    _start(pt, inputs)
    t = pt.DistributeTranspiler()
    t.transpile(trainer_id=0, trainers=1)
    mesh = pt.make_mesh((world // 2, 2), ("dp", "ep"))
    pe = _pe(pt, cost, mesh, t.build_strategy(mesh))
    return {"losses": _losses(pe, cost, _ctr_batches(4))}


def case_tfm_dptp_dropout(inputs, rank, world):
    """The Transformer at dropout 0.1 over dp x tp with the default
    sharding table: equal to the port's single-device run."""
    import paddle_tpu_torch as pt

    cost = _build_tfm(pt, 0.1)
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.sharding_rules = True
    pe = _pe(pt, cost, pt.make_mesh((world // 2, 2), ("dp", "tp")), bs)
    losses = _losses(pe, cost, _tfm_batches())
    scope = pt.global_scope()
    names = sorted(n for n in _state_in(inputs))
    full = pe.gathered_state({n: scope.var(n) for n in names})
    plan = next(iter(pe._plans.values()))
    ops = plan.program.global_block().ops
    out = {"losses": losses,
           # tensor parallelism engaged: the weights used at their tp
           # split, the heads made local, the row products summed over tp
           "q_shape": np.array(scope.var("enc0_attn_q.w_0").shape),
           "gathered_weights": np.array(sorted(
               op.inputs["X"][0] for op in ops if op.type == "c_reshard"
               and op.inputs["X"][0].endswith(".w_0")) or [""]),
           "head_shapes": np.array([op.attrs["shape"] for op in ops
                                    if op.type == "reshape"][:1]),
           "tp_sums": np.array(sum(op.type == "c_allreduce"
                                   and op.attrs["axes"] == ["tp"]
                                   for op in ops))}
    out.update({"S:" + n: full[n].numpy() for n in names})
    return out


def _health_snapshot(run, feeds):
    """The health probe's last snapshot after ``run`` over ``feeds`` (the
    probe on at cadence 1): {layer: [grad_norm, param_norm,
    update_ratio, nonfinite]}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.monitor import health

    pt.flags.set_flags({"health": True, "health_every": 1})
    try:
        for f in feeds:
            run(f)
        snap = health.last_snapshot()
    finally:
        pt.flags.set_flags({"health": False, "health_every": 10})
    return {k: [d["grad_norm"], d["param_norm"], d["update_ratio"],
                d["nonfinite"]] for k, d in snap["layers"].items()}


def case_health_fsdp(inputs, rank, world):
    """The health probe under fsdp (dp 2 x fsdp 2, the state ZeRO-split):
    the stats of the global tensors, every rank alike."""
    import paddle_tpu_torch as pt

    loss = _build_mlp(pt)
    _start(pt, inputs)
    bs = pt.BuildStrategy()
    bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
    pe = _pe(pt, loss, pt.make_mesh((2, 2), ("dp", "fsdp")), bs)
    snap = _health_snapshot(lambda f: pe.run([loss], feed=f), _data(3))
    return {"labels": np.array(sorted(snap)),
            "stats": np.array([snap[k] for k in sorted(snap)])}


def case_skip_guard(inputs, rank, world):
    """The skip guard under dp: the last rank's rows of step 1 poisoned;
    the fetched loss is global, so every rank reaches the same verdict
    and skips the same step (its state bit-equal to before)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import guardian

    loss = _build_mlp(pt)
    _start(pt, inputs)
    pt.flags.set_flags({"guardian": True})
    guardian.install(guardian.Guardian(policy="skip"))
    try:
        pe = _pe(pt, loss, pt.make_mesh((world,)))
        feeds = _poisoned_data()
        scope = pt.global_scope()
        losses = [float(pe.run([loss], feed=feeds[0])[0].ravel()[0])]
        before = {n: scope.var(n).numpy().copy()
                  for n in scope.local_var_names()}
        losses.append(float(pe.run([loss], feed=feeds[1])[0].ravel()[0]))
        kept = all(np.array_equal(before[n], scope.var(n).numpy())
                   for n in before)
        losses.append(float(pe.run([loss], feed=feeds[2])[0].ravel()[0]))
    finally:
        guardian.uninstall()
        pt.flags.set_flags({"guardian": False})
    return {"losses": np.array(losses), "kept": np.array(kept)}


def _poisoned_data():
    feeds = _data(steps=3)
    feeds[1]["img"][-4:] = np.nan       # the last rank's rows (dp 4)
    return feeds


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# the parent: inputs, the world, the JAX references
# ---------------------------------------------------------------------------

def _jax_state(build):
    """The JAX startup state of the program ``build(fluid)`` emits, built
    under a fresh name counter (the names the port's rank builds)."""
    import paddle_tpu as fluid
    from paddle_tpu import unique_name

    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start), unique_name.guard():
        build(fluid)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(start, scope=scope)
    return {"S:" + v.name: np.array(scope.find_var(v.name), copy=True)
            for v in start.list_vars() if v.persistable}


def _port_state(build):
    import paddle_tpu_torch as pt

    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        build(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(start, scope=scope)
    return {"S:" + v.name: scope.var(v.name).numpy().copy()
            for v in start.list_vars() if v.persistable}


def _inputs():
    mlp = _jax_state(_build_mlp)
    return {
        "mlp_dp": mlp, "mlp_kreduce": mlp, "mlp_dptp": mlp,
        "mlp_feedlist": mlp, "mlp_uneven": mlp, "mlp_uneven_trim": mlp,
        "mlp_reject": mlp, "mlp_tp_policy": mlp, "mlp_bad_policy": mlp,
        "emb_dp_parity": _jax_state(lambda f: _build_sr(
            f, True, lambda pkg: pkg.optimizer.SGD(0.1))),
        "emb_rowshard": _jax_state(lambda f: _build_dist_tower(f, V)),
        "emb_no_dense": _jax_state(lambda f: _build_dist_tower(f, 4096)),
        "ctr_ep": _jax_state(lambda f: _build_ctr(f, True)),
        "health_fsdp": mlp, "skip_guard": mlp,
        "tfm_dptp_dropout": _port_state(lambda p: _build_tfm(p, 0.1)),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    res = run_world(os.path.abspath(__file__), WORLD, sorted(CASES),
                    tmp_path_factory.mktemp("pe_world"), inputs)
    return res, inputs


def _one(world, case):
    """Rank 0's arrays of ``case``, after checking every rank fetched the
    same arrays (fetches are global on every rank)."""
    res = world[0][case]
    for r in res[1:]:
        for k in res[0]:
            if k.startswith("__") or k in ("coords", "w_local_shape",
                                           "local_rows", "moment_rows",
                                           "table_bytes", "calls"):
                continue
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    assert not error_of(res[0]), res[0].get("__trace__")
    return res[0]


def _jax_losses(build, feeds, mesh_shape=(WORLD,), axes=None, bs=None,
                fetch=None):
    """The JAX ParallelExecutor's losses on conftest's virtual devices at
    ``mesh_shape``, from its own (identical, seeded) startup state."""
    import paddle_tpu as fluid
    from paddle_tpu.parallel import make_mesh

    loss = build(fluid)
    fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
    pe = fluid.ParallelExecutor(
        loss_name=loss.name, build_strategy=bs(fluid) if bs else None,
        mesh=make_mesh(mesh_shape, axes))
    return np.array([float(np.asarray(pe.run(feed=f, fetch_list=[loss])[0])
                           .ravel()[0]) for f in feeds])


def _port_single(build, state, feeds, fetch=("loss",)):
    """The port's single-device Executor losses from ``state``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import load_numpy_state

    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        loss = build(pt)
    scope = pt.Scope()
    load_numpy_state(scope, start, _state_in(state), "cpu")
    exe = pt.Executor(pt.CPUPlace())
    losses = np.array([float(np.asarray(exe.run(
        main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0])
        for f in feeds])
    return losses, scope


def test_parallel_matches_single_device(world):
    got = _one(world, "mlp_dp")["losses"]
    want = _jax_losses(_build_mlp, _data())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    single, _ = _port_single(_build_mlp, world[1]["mlp_dp"], _data())
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]


def test_parallel_kreduce_sharded_optimizer(world):
    r = _one(world, "mlp_kreduce")
    want = _jax_losses(_build_mlp, _data(), bs=lambda f: _kreduce(f))
    np.testing.assert_allclose(r["losses"], want, rtol=1e-4, atol=1e-5)
    single, _ = _port_single(_build_mlp, world[1]["mlp_kreduce"], _data())
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4, atol=1e-5)
    # ZeRO: the [32, 64] weight held as a quarter on every rank
    assert str(r["w_spec"]) == "PartitionSpec('dp',)"
    for rr in world[0]["mlp_kreduce"]:
        assert rr["w_local_shape"].tolist() == [8, 64]


def _kreduce(fluid):
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return bs


def test_parallel_2d_mesh_dp_tp(world):
    got = _one(world, "mlp_dptp")["losses"]
    want = _jax_losses(_build_mlp, _data(batch=8), (2, 2), ("dp", "tp"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_parallel_feed_list_form(world):
    assert np.isfinite(_one(world, "mlp_feedlist")["loss"]).all()


def test_parallel_uneven_batch_matches_single_device(world):
    r = _one(world, "mlp_uneven")
    single, _ = _port_single(_build_mlp, world[1]["mlp_uneven"],
                             _uneven_data())
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4, atol=1e-5)
    want = _jax_losses(_build_mlp, _uneven_data())
    np.testing.assert_allclose(r["losses"], want, rtol=1e-4, atol=1e-5)
    assert int(r["padded"]) == 1


def test_parallel_uneven_batch_trims_per_sample_fetches(world):
    r = _one(world, "mlp_uneven_trim")
    assert r["logits"].shape[0] == 9        # trimmed back from 36
    assert np.isfinite(r["loss"]).all()
    assert int(r["padded"]) == 1


def test_parallel_rejects_indivisible_batch_when_disabled(world):
    for r in world[0]["mlp_reject"]:
        assert error_of(r).startswith("ValueError") \
            and "divisible" in error_of(r)


def test_parallel_tensor_parallel_policy(world):
    r = _one(world, "mlp_tp_policy")
    from jax.sharding import PartitionSpec as JP

    def spec(f):
        bs = f.BuildStrategy()
        bs.param_sharding_fn = lambda name, shape: (
            JP(None, "tp") if len(shape) == 2 and shape[1] % 2 == 0
            else None)
        return bs

    want = _jax_losses(_build_mlp, _data(batch=8), (2, 2), ("dp", "tp"),
                       bs=spec)
    np.testing.assert_allclose(r["losses"], want, rtol=1e-4, atol=1e-5)
    single, _ = _port_single(_build_mlp, world[1]["mlp_tp_policy"],
                             _data(batch=8))
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4, atol=1e-5)
    # the [32, 64] weight's columns split over tp
    for rr in world[0]["mlp_tp_policy"]:
        assert rr["w_local_shape"].tolist() == [32, 32]


def test_parallel_bad_policy_spec_raises(world):
    for r in world[0]["mlp_bad_policy"]:
        assert error_of(r).startswith("ValueError") \
            and "does not divide" in error_of(r)


def test_make_mesh_shapes(world):
    res = world[0]["mesh_shapes"]
    for rank, r in enumerate(res):
        assert int(r["size"]) == WORLD
        assert r["names"].tolist() == ["dp", "tp", "sp"]
        assert r["coords"].tolist() == [rank // 2, 0, rank % 2]
        assert "needs 256 ranks" in str(r["too_big"])
    import paddle_tpu_torch as pt

    # without a world: the one-rank mesh, and any shape a description
    assert pt.make_mesh().shape == (1,)
    assert pt.make_mesh((2, 2, 2), ("dp", "tp", "sp")).size == 8


def test_distributed_embedding_sharding_fn():
    """``tests/test_selected_rows.py:188``, in-process: the plan fn
    row-shards is_distributed tables over ep, and their moments."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import (PartitionSpec as P,
                                           distributed_embedding_sharding_fn)

    with pt.program_guard(pt.Program(), pt.Program()), \
            pt.unique_name.guard():
        ids = pt.layers.data("ids", shape=[4, 1], dtype="int64")
        emb = pt.layers.embedding(ids, size=[V, D], is_distributed=True,
                                  param_attr=pt.ParamAttr(name="dist_w"))
        pt.layers.fc(pt.layers.reduce_mean(emb, dim=1), size=2)
        mesh = pt.make_mesh((4, 2), ("dp", "ep"))
        fn = distributed_embedding_sharding_fn(pt.default_main_program(),
                                               mesh)
    assert fn("dist_w", (V, D)) == P("ep")
    assert fn("dist_w_moment1_0", (V, D)) == P("ep")
    assert fn("fc_0.w_0", (D, 2)) is None
    assert fn("dist_w", (V + 1, D)) is None
    with pytest.raises(ValueError, match="axis"):
        distributed_embedding_sharding_fn(pt.default_main_program(), mesh,
                                          axis="tp")


def test_sharded_embedding_parallel_parity(world):
    r = _one(world, "emb_dp_parity")
    dense, scope = _port_single(
        lambda p: _build_sr(p, False, lambda pkg: pkg.optimizer.SGD(0.1)),
        world[1]["emb_dp_parity"], _sr_batches())
    np.testing.assert_allclose(r["losses"], dense, rtol=1e-4)
    np.testing.assert_allclose(r["emb_w"], scope.var("emb_w").numpy(),
                               rtol=1e-4, atol=1e-6)
    assert int(r["local_rows"]) == V // WORLD


def test_rowsharded_pe_sparse_update_engages_and_matches(world):
    r = _one(world, "emb_rowshard")
    single, scope = _port_single(lambda p: _build_dist_tower(p, V),
                                 world[1]["emb_rowshard"],
                                 _dup_batches(V, steps=3))
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4)
    np.testing.assert_allclose(r["emb_w"], scope.var("emb_w").numpy(),
                               rtol=1e-4, atol=1e-6)
    assert bool(r["stable"])
    for rr in world[0]["emb_rowshard"]:
        lookups, updates = rr["calls"].tolist()
        assert lookups >= 1 and updates >= 1
        # the moments ride the table's rows: never a replicated [V, D]
        assert rr["moment_rows"].tolist() == [V // 2, V // 2]
    assert all(s == "PartitionSpec('ep',)" for s in r["specs"])


def test_mesh_sharded_sparse_never_materializes_dense_table_grad(world):
    vocab = 4096
    for rr in world[0]["emb_no_dense"]:
        assert int(rr["to_dense"]) == 0
        assert rr["table_gathers"].tolist() == [""]
        # the table and its two Adam moments: a half each (ep = 2)
        assert int(rr["table_bytes"]) == vocab * D * 4 * 3 // 2


def test_ctr_dnn_ep_sharded_loss_parity(world):
    r = _one(world, "ctr_ep")
    single, _ = _port_single(lambda p: _build_ctr(p, True),
                             world[1]["ctr_ep"], _ctr_batches(4))
    np.testing.assert_allclose(r["losses"], single, rtol=2e-4, atol=1e-5)

    def plan(f):
        t = f.DistributeTranspiler()
        t.transpile(trainer_id=0, trainers=1)
        from paddle_tpu.parallel import make_mesh

        return t.build_strategy(make_mesh((2, 2), ("dp", "ep")))

    want = _jax_losses(lambda f: _build_ctr(f, True), _ctr_batches(4),
                       (2, 2), ("dp", "ep"), bs=plan)
    np.testing.assert_allclose(r["losses"], want, rtol=2e-4, atol=1e-5)


def test_dropout_transformer_dp_tp_equals_single_device(world):
    """Dropout 0.1 over dp x tp with the default table: real tensor
    parallelism (each rank one of the two heads and half of every
    projection's columns or rows) and the ranks drawing the
    single-device run's masks (dropout at the global shape, the attention
    hash at the global batch and head rows), so the trajectory and the
    trained state are the single-device run's."""
    r = _one(world, "tfm_dptp_dropout")
    # the q projection's columns (and heads) split over tp: [16, 8] a
    # rank, no weight gathered, one head a rank, the row products summed
    assert r["q_shape"].tolist() == [16, 8]
    assert r["gathered_weights"].tolist() == [""]
    assert r["head_shapes"].tolist() == [[0, 0, 1, 8]]
    assert int(r["tp_sums"]) >= 2
    single, scope = _port_single(lambda p: _build_tfm(p, 0.1),
                                 world[1]["tfm_dptp_dropout"],
                                 _tfm_batches())
    np.testing.assert_allclose(r["losses"], single, rtol=1e-4, atol=1e-5)
    assert r["losses"][-1] < r["losses"][0]
    for k, v in r.items():
        if k.startswith("S:"):
            np.testing.assert_allclose(v, scope.var(k[2:]).numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_health_probe_covers_the_global_tensors(world):
    """Under fsdp each rank holds a quarter of the state and its own
    rows' gradients; the probe's per-layer norms and update ratios are
    the single-device run's (the shards' sums added over the world, a
    replicated var counted once)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import load_numpy_state

    r = _one(world, "health_fsdp")
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        loss = _build_mlp(pt)
    scope = pt.Scope()
    load_numpy_state(scope, start, _state_in(world[1]["health_fsdp"]),
                     "cpu")
    exe = pt.Executor(pt.CPUPlace())
    want = _health_snapshot(lambda f: exe.run(
        main, feed=f, fetch_list=[loss], scope=scope), _data(3))
    assert r["labels"].tolist() == sorted(want)
    np.testing.assert_allclose(r["stats"],
                               np.array([want[k] for k in sorted(want)]),
                               rtol=1e-4, atol=1e-7)


def test_skip_guard_skips_the_same_step_on_every_rank(world):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import guardian
    from paddle_tpu_torch.convert import load_numpy_state

    res = world[0]["skip_guard"]
    for r in res:
        assert not error_of(r), r.get("__trace__")
        assert bool(r["kept"])
        assert not np.isfinite(r["losses"][1])
        np.testing.assert_array_equal(r["losses"], res[0]["losses"])
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        loss = _build_mlp(pt)
    scope = pt.Scope()
    load_numpy_state(scope, start, _state_in(world[1]["skip_guard"]),
                     "cpu")
    pt.flags.set_flags({"guardian": True})
    guardian.install(guardian.Guardian(policy="skip"))
    try:
        exe = pt.Executor(pt.CPUPlace())
        want = [float(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0].ravel()[0])
                for f in _poisoned_data()]
    finally:
        guardian.uninstall()
        pt.flags.set_flags({"guardian": False})
    np.testing.assert_allclose(res[0]["losses"][[0, 2]],
                               np.array(want)[[0, 2]], rtol=1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_world_of_one_bit_equal_to_executor(dropout):
    """Without a world the mesh is one rank's and the plan's program the
    single-device program: losses and every state var bit-equal to
    ``Executor`` over the same steps from the same state."""
    import paddle_tpu_torch as pt

    state = _port_state(lambda p: _build_tfm(p, dropout))
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        cost = _build_tfm(pt, dropout)
    from paddle_tpu_torch.convert import load_numpy_state

    runs = {}
    for kind in ("executor", "pe"):
        scope = pt.Scope()
        load_numpy_state(scope, start, _state_in(state), "cpu")
        if kind == "executor":
            exe = pt.Executor(pt.CPUPlace())
            run = lambda f: exe.run(main, feed=f, fetch_list=[cost],  # noqa
                                    scope=scope)[0]
        else:
            bs = pt.BuildStrategy()
            bs.sharding_rules = True
            bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
            pe = pt.ParallelExecutor(
                use_cuda=False, loss_name=cost.name, main_program=main,
                scope=scope, build_strategy=bs,
                mesh=pt.make_mesh((1, 1, 1), ("dp", "fsdp", "tp")))
            run = lambda f: pe.run([cost], feed=f)[0]  # noqa: E731
        losses = [run(f).tobytes() for f in _tfm_batches()]
        runs[kind] = (losses, {n: scope.var(n).numpy().tobytes()
                               for n in scope.local_var_names()})
    assert runs["pe"][0] == runs["executor"][0]
    assert runs["pe"][1] == runs["executor"][1]
    # no collective at all in the world of one
    assert not next(iter(pe._plans.values())).counts


def test_use_cuda_without_a_card_raises():
    import paddle_tpu_torch as pt

    with pytest.raises(RuntimeError, match="CUDA"):
        pt.ParallelExecutor(use_cuda=True)


if __name__ == "__main__":
    from torch_mesh_world import worker

    worker(CASES)
