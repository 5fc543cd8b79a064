"""The port's high-level trainer slice on the CPU: the MNIST MLP
(``tests/test_mnist_mlp.py``'s scenarios, and a 20-step Adam trajectory
against the JAX package from its startup state), ``Trainer`` /
``Inferencer`` (``tests/test_contrib.py``'s round trip and
``tests/test_book_highlevel.py``'s fit_a_line and recognize_digits, one
fit_a_line epoch against the JAX ``Trainer``), the serial checkpoints
(``tests/test_io_checkpoint.py``, and checkpoints crossing between the
packages both ways), the refused options, and a 2+2-layer Transformer
stepping on bucketed ragged feeds against the JAX package."""

import os

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib import Trainer as JaxTrainer
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch import framework as pt_framework
from paddle_tpu_torch import unique_name as pt_unique_name
from paddle_tpu_torch.contrib import (CheckpointConfig, Inferencer,
                                      Trainer)
from paddle_tpu_torch.contrib.trainer import _default_place
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.framework import Parameter
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.reader import decorator as dec

L = pt.layers


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """Fresh port default programs, scope and name counter per test."""
    old_main = pt_framework.switch_main_program(pt.Program())
    old_startup = pt_framework.switch_startup_program(pt.Program())
    old_gen = pt_unique_name.switch()
    with pt.scope_guard(pt.Scope()):
        yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)


def _synthetic_mnist(rng, n):
    x = rng.rand(n, 784).astype("float32")
    # learnable synthetic rule: class = argmax of 10 fixed projections
    proj = np.linspace(-1, 1, 7840).reshape(784, 10).astype("float32")
    y = (x @ proj).argmax(axis=1).astype("int64").reshape(-1, 1)
    return x, y


def _startup_state(jax_startup):
    """Every persistable of a JAX startup program after its run."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jax_startup, scope=scope)
    return scope, {v.name: np.array(scope.find_var(v.name), copy=True)
                   for v in jax_startup.list_vars() if v.persistable}


# ---------------------------------------------------------------------------
# tests/test_mnist_mlp.py on the port
# ---------------------------------------------------------------------------

def test_mnist_mlp_trains():
    img = L.data("img", shape=[784])
    label = L.data("label", shape=[1], dtype="int64")
    h1 = L.fc(img, size=64, act="relu")
    h2 = L.fc(h1, size=64, act="relu")
    pred = L.fc(h2, size=10, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    acc = L.accuracy(pred, label)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)

    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())

    rng = np.random.RandomState(42)
    first_loss = last_loss = None
    accs = []
    for step in range(60):
        x, y = _synthetic_mnist(rng, 64)
        lv, av = exe.run(feed={"img": x, "label": y},
                         fetch_list=[loss, acc])
        if step == 0:
            first_loss = float(lv[0])
        last_loss = float(lv[0])
        accs.append(float(av[0]))
    assert last_loss < first_loss * 0.8, (first_loss, last_loss)
    assert np.mean(accs[-10:]) >= np.mean(accs[:10])


def test_mnist_mlp_save_load_inference(tmp_path):
    img = L.data("img", shape=[16])
    label = L.data("label", shape=[1], dtype="int64")
    pred = L.fc(img, size=4, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    rng = np.random.RandomState(7)
    x = rng.rand(8, 16).astype("float32")
    y = rng.randint(0, 4, (8, 1)).astype("int64")
    exe.run(feed={"img": x, "label": y}, fetch_list=[loss])
    (ref_pred,) = exe.run(
        pt.default_main_program().prune_feed_fetch(["img"], [pred.name]),
        feed={"img": x}, fetch_list=[pred.name])

    model_dir = str(tmp_path / "model")
    pt.io.save_inference_model(model_dir, ["img"], [pred], exe)

    with pt.scope_guard(pt.Scope()):
        exe2 = pt.Executor(pt.CPUPlace())
        program, feed_names, fetch_vars = pt.io.load_inference_model(
            model_dir, exe2)
        (loaded_pred,) = exe2.run(
            program, feed={feed_names[0]: x},
            fetch_list=[v.name for v in fetch_vars])
    np.testing.assert_allclose(ref_pred, loaded_pred, rtol=1e-5)


def test_checkpoint_save_load(tmp_path):
    img = L.data("img", shape=[8])
    pred = L.fc(img, size=2)
    loss = L.mean(pred)
    pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    x = np.random.RandomState(3).rand(4, 8).astype("float32")
    for _ in range(3):
        exe.run(feed={"img": x}, fetch_list=[loss])
    ckpt = str(tmp_path / "ckpt")
    pt.io.save_checkpoint(exe, ckpt, serial=5)
    names = [v.name for v in pt.default_main_program().list_vars()
             if v.persistable]
    snapshot = {n: pt.global_scope().var(n).numpy().copy() for n in names}

    with pt.scope_guard(pt.Scope()):
        exe2 = pt.Executor(pt.CPUPlace())
        assert pt.io.load_checkpoint(exe2, ckpt)
        for n, want in snapshot.items():
            np.testing.assert_allclose(pt.global_scope().var(n).numpy(),
                                       want)


def _mlp(pkg, hidden=64):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("img", shape=[784])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(img, size=hidden, act="relu")
        h = pkg.layers.fc(h, size=hidden, act="relu")
        pred = pkg.layers.fc(h, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        acc = pkg.layers.accuracy(pred, label)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, acc


def test_mlp_adam_trajectory_matches_jax():
    """20 Adam steps of the MLP from the JAX startup state: the programs
    serialize alike, the losses agree within rtol 1e-4 at every step and
    ``accuracy`` is equal; the final parameters within 1e-4 of each
    parameter's largest magnitude."""
    jm, js, jl, ja = _mlp(fluid)
    tm, ts, tl, ta = _mlp(pt)
    assert tm.to_dict() == jm.to_dict()
    jscope, state = _startup_state(js)
    tscope = pt.Scope()
    load_numpy_state(tscope, ts, state, "cpu")
    jexe, texe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(42)
    accs = []
    for _ in range(20):
        x, y = _synthetic_mnist(rng, 64)
        want = jexe.run(jm, feed={"img": x, "label": y}, fetch_list=[jl, ja],
                        scope=jscope)
        got = texe.run(tm, feed={"img": x, "label": y}, fetch_list=[tl, ta],
                       scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        accs.append(float(got[1][0]))
    assert accs[-1] > accs[0]
    for p in tm.all_parameters():
        want = np.asarray(jscope.find_var(p.name))
        got = tscope.var(p.name).numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), p.name


# ---------------------------------------------------------------------------
# Trainer / Inferencer (tests/test_contrib.py, tests/test_book_highlevel.py)
# ---------------------------------------------------------------------------

def _losses_collector(losses):
    def handler(event):
        if hasattr(event, "metrics"):
            losses.append(float(np.asarray(event.metrics[0]).reshape(())))
    return handler


def test_trainer_inferencer_roundtrip(tmp_path):
    def net():
        img = L.data("img", shape=[8])
        h = L.fc(img, size=16, act="relu")
        return L.fc(h, size=4, act="softmax")

    def train_func():
        pred = net()
        label = L.data("label", shape=[1], dtype="int64")
        return L.mean(L.cross_entropy(pred, label))

    rng = np.random.RandomState(0)
    feats = rng.rand(64, 8).astype("float32")
    data = [(x, int(np.argmax(x[:4]))) for x in feats]

    def reader():
        for i in range(0, len(data), 8):
            yield data[i:i + 8]

    losses, events = [], []

    def handler(e):
        events.append(type(e).__name__)
        if hasattr(e, "metrics"):
            losses.append(float(np.asarray(e.metrics[0]).reshape(())))

    trainer = Trainer(train_func=train_func,
                      optimizer_func=lambda: pt.optimizer.SGD(0.5),
                      place=pt.CPUPlace())
    trainer.train(num_epochs=6, event_handler=handler, reader=reader,
                  feed_order=["img", "label"])
    assert losses and np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < np.mean(losses[:8])
    assert events[:3] == ["BeginEpochEvent", "BeginStepEvent",
                          "EndStepEvent"]
    assert events.count("EndEpochEvent") == 6
    assert len(losses) == 48

    param_dir = str(tmp_path / "params")
    trainer.save_params(param_dir)

    inferencer = Inferencer(infer_func=net, param_path=param_dir,
                            place=pt.CPUPlace())
    x = rng.rand(5, 8).astype("float32")
    (probs,) = inferencer.infer({"img": x})
    assert probs.shape == (5, 4)
    np.testing.assert_allclose(probs.sum(axis=1), np.ones(5), atol=1e-5)

    inf_params = [
        name for name, v in
        inferencer.inference_program.global_block().vars.items()
        if isinstance(v, Parameter)]
    assert inf_params
    for name in inf_params:
        saved = np.load(os.path.join(param_dir, name + ".npy"))
        np.testing.assert_array_equal(saved,
                                      inferencer.scope.var(name).numpy())

    with pytest.raises(ValueError):
        inferencer.infer([x])
    with pytest.raises(ValueError):
        Inferencer(infer_func=net, param_path=str(tmp_path / "nope"),
                   place=pt.CPUPlace())
    # test(): the train_func outputs averaged over a reader
    (mean_loss,) = trainer.test(reader, feed_order=["img", "label"])
    assert np.isfinite(mean_loss)


def test_trainer_stop_and_fetch_metrics():
    """``stop()`` ends training at the next step; a ``BeginStepEvent``
    with ``fetch_metrics`` False fetches nothing."""
    def train_func():
        x = L.data("x", shape=[4])
        y = L.data("y", shape=[1])
        return L.mean(L.square_error_cost(L.fc(x, size=1), y))

    rng = np.random.RandomState(1)
    data = [(rng.rand(4).astype("float32"), rng.rand(1).astype("float32"))
            for _ in range(40)]
    trainer = Trainer(train_func, lambda: pt.optimizer.SGD(0.1),
                      place=pt.CPUPlace())
    seen = []

    def handler(e):
        if type(e).__name__ == "BeginStepEvent":
            e.fetch_metrics = e.step % 2 == 0
        if hasattr(e, "metrics"):
            seen.append(len(e.metrics))
            if len(seen) == 7:
                trainer.stop()

    trainer.train(3, handler, reader=pt.batch(lambda: iter(data), 4),
                  feed_order=["x", "y"])
    assert seen == [1, 0, 1, 0, 1, 0, 1]


def test_trainer_refusals_and_default_place():
    cfg = CheckpointConfig(checkpoint_dir="x")
    assert (cfg.checkpoint_dir, cfg.step_interval, cfg.load_serial) == (
        "x", 10, None)

    def train_func():
        return L.mean(L.fc(L.data("x", shape=[2]), size=1))

    opt = lambda: pt.optimizer.SGD(0.1)  # noqa: E731
    # autotune= is ported (tests/test_torch_autotune.py), and parallel=
    # and mesh= (tests/test_torch_dist_train.py); cluster_member= still
    # raises (A7c)
    for kw in (dict(parallel=True), dict(mesh=pt.make_mesh())):
        assert Trainer(train_func, opt, place=pt.CPUPlace(), **kw).parallel
    with pytest.raises(NotImplementedError, match="A7c"):
        Trainer(train_func, opt, place=pt.CPUPlace(),
                cluster_member=object())
    with pytest.raises(TypeError, match="CheckpointConfig"):
        Trainer(train_func, opt, place=pt.CPUPlace(),
                checkpoint_config=object())
    with pytest.raises(NotImplementedError, match="ParallelExecutor"):
        Inferencer(lambda: None, ".", parallel=True)
    # no place: the first card, never the CPU
    assert _default_place(None) == pt.CUDAPlace(0)
    assert _default_place(pt.CPUPlace()) == pt.CPUPlace()


def _fit_a_line_parts(pkg):
    W = np.array([[1.5], [-2.0], [0.5], [3.0]], "float32")

    def net():
        x = pkg.layers.data("x", shape=[4])
        return pkg.layers.fc(x, size=1, act=None)

    def train_func():
        y_pred = net()
        y = pkg.layers.data("y", shape=[1])
        return pkg.layers.mean(pkg.layers.square_error_cost(y_pred, y))

    rng = np.random.RandomState(0)
    xs = rng.rand(128, 4).astype("float32")
    data = list(zip(xs, xs @ W + 0.7))

    def reader():
        for i in range(0, len(data), 16):
            yield data[i:i + 16]

    return W, net, train_func, reader, rng


def test_fit_a_line_highlevel(tmp_path):
    W, net, train_func, reader, rng = _fit_a_line_parts(pt)
    losses = []
    trainer = Trainer(train_func=train_func,
                      optimizer_func=lambda: pt.optimizer.SGD(0.3),
                      place=pt.CPUPlace())
    trainer.train(num_epochs=30, event_handler=_losses_collector(losses),
                  reader=reader, feed_order=["x", "y"])
    assert losses[-1] < 0.01, losses[-1]

    param_dir = str(tmp_path / "fit_a_line")
    trainer.save_params(param_dir)
    inferencer = Inferencer(infer_func=net, param_path=param_dir,
                            place=pt.CPUPlace())
    probe = rng.rand(8, 4).astype("float32")
    (pred,) = inferencer.infer({"x": probe})
    np.testing.assert_allclose(pred, probe @ W + 0.7, atol=0.25)


def test_fit_a_line_epoch_matches_the_jax_trainer(tmp_path):
    """The JAX ``Trainer``'s initial parameters saved by its
    ``save_params`` and loaded by the port's ``Trainer(param_path=)``:
    one epoch of losses within rtol 1e-4, and the final parameters."""
    _, _, jax_train_func, reader, _ = _fit_a_line_parts(fluid)
    jt = JaxTrainer(train_func=jax_train_func,
                    optimizer_func=lambda: fluid.optimizer.SGD(0.3),
                    place=fluid.CPUPlace())
    init_dir = str(tmp_path / "init")
    jt.save_params(init_dir)
    want = []
    jt.train(num_epochs=1, event_handler=_losses_collector(want),
             reader=reader, feed_order=["x", "y"])

    _, _, train_func, reader, _ = _fit_a_line_parts(pt)
    t = Trainer(train_func=train_func,
                optimizer_func=lambda: pt.optimizer.SGD(0.3),
                param_path=init_dir, place=pt.CPUPlace())
    got = []
    t.train(num_epochs=1, event_handler=_losses_collector(got),
            reader=reader, feed_order=["x", "y"])
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for p in t.train_program.all_parameters():
        np.testing.assert_allclose(t.scope.var(p.name).numpy(),
                                   np.asarray(jt.scope.var(p.name)),
                                   rtol=1e-4, atol=1e-6)


def test_recognize_digits_conv_highlevel(tmp_path):
    def net():
        img = L.data("img", shape=[1, 12, 12])
        conv_pool = pt.nets.simple_img_conv_pool(
            input=img, filter_size=3, num_filters=4, pool_size=2,
            pool_stride=2, act="relu")
        return L.fc(conv_pool, size=3, act="softmax")

    def train_func():
        pred = net()
        label = L.data("label", shape=[1], dtype="int64")
        return L.mean(L.cross_entropy(pred, label))

    rng = np.random.RandomState(1)
    data = []
    for _ in range(96):
        cls = rng.randint(0, 3)
        img = rng.rand(1, 12, 12).astype("float32") * 0.1
        img[0, cls * 4:(cls + 1) * 4, :] += 1.0   # bright band per class
        data.append((img, cls))

    def reader():
        for i in range(0, len(data), 16):
            yield data[i:i + 16]

    losses = []
    trainer = Trainer(train_func=train_func,
                      optimizer_func=lambda: pt.optimizer.Adam(1e-2),
                      place=pt.CPUPlace())
    trainer.train(num_epochs=8, event_handler=_losses_collector(losses),
                  reader=reader, feed_order=["img", "label"])
    assert losses[-1] < 0.2, losses[-1]

    param_dir = str(tmp_path / "digits")
    trainer.save_params(param_dir)
    inferencer = Inferencer(infer_func=net, param_path=param_dir,
                            place=pt.CPUPlace())
    imgs = np.stack([d[0] for d in data[:12]])
    (probs,) = inferencer.infer({"img": imgs})
    acc = (probs.argmax(1) == np.array([d[1] for d in data[:12]])).mean()
    assert acc > 0.8, acc


# ---------------------------------------------------------------------------
# serial checkpoints (tests/test_io_checkpoint.py), across the packages
# ---------------------------------------------------------------------------

def _ckpt_model(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[4])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=8, act="relu")
        pred = pkg.layers.fc(h, size=3, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _persistables(pkg, scope, program):
    return {v.name: np.array(scope.find_var(v.name), copy=True)
            if pkg is fluid else scope.find_var(v.name).numpy().copy()
            for v in program.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def test_checkpoint_serials_and_resume(tmp_path):
    main, startup, _ = _ckpt_model(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    ckdir = str(tmp_path / "ckpt")
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_checkpoint(exe, ckdir, main_program=main)
        pt.io.save_checkpoint(exe, ckdir, main_program=main)
        assert pt.io.get_latest_checkpoint_serial(ckdir) == 1
        before = {p.name: scope.var(p.name).numpy().copy()
                  for p in main.all_parameters()}
    scope2 = pt.Scope()
    with pt.scope_guard(scope2):
        exe.run(startup)
        pt.io.load_checkpoint(exe, ckdir, main_program=main)
        for k, v in before.items():
            np.testing.assert_array_equal(scope2.var(k).numpy(), v)
    for _ in range(3):
        with pt.scope_guard(scope):
            pt.io.save_checkpoint(exe, ckdir, main_program=main,
                                  max_num_checkpoints=2)
    assert sorted(os.listdir(ckdir)) == ["checkpoint_3", "checkpoint_4"]
    assert pt.io.get_latest_checkpoint_serial(str(tmp_path / "no")) == -1
    assert not pt.io.load_checkpoint(exe, str(tmp_path / "no"))
    pt.io.clean_checkpoint(ckdir, delete_dir=True)
    assert not os.path.exists(ckdir)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """Three Adam steps in one package, ``save_checkpoint``; the other
    package's ``load_checkpoint`` reads every persistable (parameters,
    moments, beta powers) back equal."""
    pkgs = (pt, fluid) if writer == "port" else (fluid, pt)
    ckdir = str(tmp_path / "ck")
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(8, 4).astype("float32"),
            "label": rng.randint(0, 3, (8, 1)).astype("int64")}
    saved = None
    for i, pkg in enumerate(pkgs):
        main, startup, loss = _ckpt_model(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        with pkg.scope_guard(scope):
            exe.run(startup)
            if i == 0:
                for _ in range(3):
                    exe.run(main, feed=feed, fetch_list=[loss])
                pkg.io.save_checkpoint(exe, ckdir, main_program=main)
                saved = _persistables(pkg, scope, main)
            else:
                assert pkg.io.load_checkpoint(exe, ckdir, main_program=main)
                got = _persistables(pkg, scope, main)
    assert len(saved) > 10 and sorted(got) == sorted(saved)
    for n, want in saved.items():
        np.testing.assert_array_equal(got[n].astype(want.dtype), want)


# ---------------------------------------------------------------------------
# the Transformer on bucketed ragged feeds
# ---------------------------------------------------------------------------

VOCAB, MAX_LEN = 30, 16


def _transformer(pkg, transformer):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = [pkg.layers.data(n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("src_word", "tgt_word", "lbl_word")]
        cost, _ = transformer.transformer(
            *words, MAX_LEN, MAX_LEN, VOCAB, VOCAB, n_layer=2, n_head=2,
            d_model=64, d_inner=128, dropout_rate=0.0)
        pkg.optimizer.Adam(
            learning_rate=pkg.layers.noam_decay(64, 10), beta1=0.9,
            beta2=0.997, epsilon=1e-9).minimize(cost)
    return main, startup, cost, words


def test_transformer_steps_on_bucketed_feeds_like_jax():
    """bench.py's realdist feed path at 2+2 layers, d_model 64, float32,
    dropout 0: bench.py's lengths scaled to max_len 16 (a quarter of 64:
    clip(lognormal(3.2 - 1.4, 0.55), 2, 16)) grouped by
    ``bucket_by_length`` (bounds 8 and 16, sizes 6 and 3) and fed by
    ``DataFeeder.feed(samples, pad_to=bound)`` (source = target = label,
    ragged, with ``@LEN``).  One step on each bound from the JAX startup
    state: the loss within rtol 1e-4 and every parameter gradient within
    rtol 1e-4 (atol 1e-4 of the gradient's largest magnitude) of the JAX
    package's; the padded label tokens carry no loss."""
    jm, js, jc, _ = _transformer(fluid, jax_transformer)
    tm, ts, tc, words = _transformer(pt, pt_transformer)
    assert tm.to_dict() == jm.to_dict()
    jscope, state = _startup_state(js)
    tscope = pt.Scope()
    load_numpy_state(tscope, ts, state, "cpu")
    feeder = pt.DataFeeder(feed_list=words, place=pt.CPUPlace(), program=tm)

    def stream():
        rng = np.random.RandomState(0)
        while True:
            n = int(np.clip(rng.lognormal(1.8, 0.55), 2, MAX_LEN))
            yield (rng.randint(2, VOCAB, (n, 1)).astype("int64"),)

    batches = {}
    for bound, samples in dec.bucket_by_length(
            stream, lambda s: len(s[0]), [8, 16], [6, 3])():
        batches.setdefault(bound, samples)
        if len(batches) == 2:
            break
    params = [p.name for p in tm.all_parameters() if p.trainable]
    fetch = [tc.name] + [n + "@GRAD" for n in params]
    jexe, texe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    for bound in (8, 16):
        feed = feeder.feed([(s, s, s) for (s,) in batches[bound]],
                           pad_to=bound)
        assert feed["src_word"].shape == (len(batches[bound]), bound, 1)
        lens = feed["lbl_word@LEN"]
        assert (lens < bound).any() and (lens > bound // 2).all()
        want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4)
        for n, g, w in zip(params, got[1:], want[1:]):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg="%s bound %d" % (n, bound))
        # a change in a padded label position changes nothing
        poked = dict(feed)
        poked["lbl_word"] = feed["lbl_word"].copy()
        row = int(np.argmin(feed["lbl_word@LEN"]))
        poked["lbl_word"][row, feed["lbl_word@LEN"][row]:] = 1
        test_prog = tm.clone(for_test=True).prune_feed_fetch(
            sorted(feed), [tc.name])
        assert not any(op.type == "adam" for op in test_prog.global_block()
                       .ops)
        a = texe.run(test_prog, feed=feed, fetch_list=[tc], scope=tscope)
        b = texe.run(test_prog, feed=poked, fetch_list=[tc], scope=tscope)
        assert a[0].tobytes() == b[0].tobytes()
