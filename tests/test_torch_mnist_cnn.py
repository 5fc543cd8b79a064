"""``models/mnist.py``'s conv net trained through ``contrib.Trainer`` on
the CPU, against the JAX package: the benchmark's ``cnn_model`` (two
conv-pools of 20 and 50 5x5 filters, a softmax fc over 1x28x28) with a
loss written in the new frontend (``Variable`` operators: a confidence
penalty ``1e-4 * sum(p * p)`` added to the mean cross-entropy) and an
in-program accuracy (``argmax`` / ``equal`` / ``cast``), Adam(1e-3),
three steps at batch 8 from the JAX ``Trainer``'s initial parameters
(its ``save_params``, loaded by the port's ``Trainer(param_path=)``):
losses and accuracies within rtol 1e-4, the final parameters too, and
``metrics.Accuracy`` over the fetched accuracies equal in both."""

import numpy as np

import paddle_tpu as fluid
import paddle_tpu.models.mnist  # noqa: F401
from paddle_tpu import metrics as jax_metrics
from paddle_tpu.contrib import Trainer as JaxTrainer

import paddle_tpu_torch as pt
from paddle_tpu_torch import metrics
from paddle_tpu_torch.contrib import Trainer

from test_torch_serving import fresh_torch_programs  # noqa: F401

BATCH, STEPS = 8, 3


def train_func(pkg):
    def build():
        L = pkg.layers
        img = L.data("img", shape=[1, 28, 28])
        label = L.data("label", shape=[1], dtype="int64")
        pred = pkg.models.mnist.cnn_model(img)
        ce = L.mean(L.cross_entropy(pred, label))
        loss = ce + 1e-4 * L.reduce_sum(pred * pred)
        hit = L.equal(L.argmax(pred, axis=1), L.reshape(label, [-1]))
        return [loss, L.mean(L.cast(hit, "float32"))]

    return build


def reader():
    rng = np.random.RandomState(5)
    rows = []
    for _ in range(BATCH * STEPS):
        cls = int(rng.randint(0, 10))
        img = rng.rand(1, 28, 28).astype("float32") * 0.2
        img[0, cls * 2:cls * 2 + 4, :] += 1.0     # a bright band a class
        rows.append((img, cls))
    for i in range(0, len(rows), BATCH):
        yield rows[i:i + BATCH]


def _collect(into):
    def handler(event):
        if type(event).__name__ == "EndStepEvent":
            into.append([float(np.asarray(m).ravel()[0])
                         for m in event.metrics])
    return handler


def test_cnn_trains_like_jax(tmp_path):
    jt = JaxTrainer(train_func=train_func(fluid),
                    optimizer_func=lambda: fluid.optimizer.Adam(1e-3),
                    place=fluid.CPUPlace())
    init = str(tmp_path / "init")
    jt.save_params(init)
    want = []
    jt.train(num_epochs=1, event_handler=_collect(want), reader=reader,
             feed_order=["img", "label"])

    t = Trainer(train_func=train_func(pt),
                optimizer_func=lambda: pt.optimizer.Adam(1e-3),
                param_path=init, place=pt.CPUPlace())
    assert t.train_program.to_dict() == jt.train_program.to_dict()
    got = []
    t.train(num_epochs=1, event_handler=_collect(got), reader=reader,
            feed_order=["img", "label"])
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)
    params = t.train_program.all_parameters()
    assert len(params) == 6
    for p in params:
        np.testing.assert_allclose(t.scope.var(p.name).numpy(),
                                   np.asarray(jt.scope.var(p.name)),
                                   rtol=1e-4, atol=1e-6)
    accs = []
    for m in (metrics, jax_metrics):
        acc = m.Accuracy()
        for (_, a) in (got if m is metrics else want):
            acc.update(value=a, weight=BATCH)
        accs.append(acc.eval())
    np.testing.assert_allclose(accs[0], accs[1], rtol=1e-6)


def test_cnn_program_shapes():
    """The net's shapes at full width: 20 5x5 filters, 2x2 pools, 50
    filters, an fc of 800 -> 10."""
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        train_func(pt)()
    shapes = sorted(tuple(p.shape) for p in main.all_parameters())
    assert shapes == sorted([(20, 1, 5, 5), (20,), (50, 20, 5, 5), (50,),
                             (800, 10), (10,)])
    types = [op.type for op in main.global_block().ops]
    for t in ("arg_max", "equal", "cast", "scale", "elementwise_mul",
              "elementwise_add", "reduce_sum"):
        assert t in types, t
